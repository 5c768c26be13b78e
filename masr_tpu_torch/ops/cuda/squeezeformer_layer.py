"""Full-context Squeezeformer encoder layer: the Hopper kernel and its plain
twin.

Port of masr_tpu/ops/pallas/squeezeformer_layer.py
(`fused_squeezeformer_layer`, `pack_sq_layer_params`). The CUDA source is
masr_tpu_torch/csrc/squeezeformer_layer.cu; its header says how the
post-norm layer is split into kernels, what bounds it on the H100 and what
is left for later.

`fused_squeezeformer_layer` launches the kernel for a CUDA tensor and takes
the plain PyTorch version, `fused_squeezeformer_layer_plain`, only for a CPU
tensor. It counts its kernel launches in `fused_squeezeformer_layer.launches`,
one per layer call, and those of its bf16 mode in `.bf16_launches` as well.
Its products and attention run as the Conformer layer kernel's
(conformer_layer.py: the serving tensor-core pack, `full_plan`, the flash
attention with a key-length mask).

Operands are f32, with the adaptive scales of the attention and the FFNs
folded into the weights before the pack splits them; or bf16, the bf16
mode of masr_tpu's kernel (`cdt = x_ref.dtype`,
masr_tpu/ops/pallas/squeezeformer_layer.py:46): x, pos_p and the output
bf16, the products' weights bf16 and unfolded, the LN, bias, adaptive
scale and folded BatchNorm rows f32 (`pack_sq_layer_params(layer,
torch.bfloat16)`), the activations f32 inside, each adaptive scale applied
in f32 before its product rounds the operand to bf16 (a fold would move
that rounding point), every product summing in f32 (`operand_mm`), and
the attention rounding [q+u | q+v], [k | p], the normalised
probabilities and v. Mixed or other dtypes raise (chunk_layer.py
check_serving_dtypes).
"""
import torch
import torch.nn.functional as F

from masr_tpu_torch.ops.cuda.chunk_layer import (TC_KEYS, check_chunk_tc,
                                                 check_serving_dtypes,
                                                 chunk_entry,
                                                 launch_tc_kernel,
                                                 operand_mm,
                                                 with_chunk_tc)
from masr_tpu_torch.ops.cuda.conformer_layer import (check_layer_args,
                                                     full_plans,
                                                     glu_depthwise_plain,
                                                     rel_pos_attention_plain)

SQ_PACKED_KEYS = ("lnw", "ada", "cnw", "attw", "vecb", "posb", "ffw1",
                  "ffb1", "ffw2", "pw1w", "pw1b", "pw2w", "dww")
# the serving pack's arrays that the serving kernels (full context and
# chunk) read besides the tensor-core pack, in their C argument order; f32
# in either mode
SQ_SERVE_KEYS = ("lnw", "ada", "cnw", "vecb", "posb", "ffb1", "pw1b", "dww")


def pack_sq_layer_params(layer, dtype=torch.float32):
    """One SqueezeformerEncoderLayer (masr_tpu_torch.models.squeezeformer)
    → the kernels' arrays, matmul weights as (in, out):
      lnw (4, 2, D)   LN1..LN4 scale, shift
      ada (2, D)      the conv module's adaptive scale, shift
      cnw (2, D)      the conv norm: LN scale, shift, or the BatchNorm
                      folded to a per-channel affine from its running
                      statistics (exact in eval)
      attw (4, D, D)  q, k, v, out; vecb (8, D) their biases, the FFN1 and
                      FFN2 w_2 biases, the depthwise and pw2 biases
      posb (2, D)     pos_bias_u, pos_bias_v
      ffw1 (2, D, F), ffb1 (2, F), ffw2 (2, F, D)   FFN1, FFN2
      pw1w (D, 2D), pw1b (1, 2D), pw2w (D, D), dww (k, D)
    In f32 the attention's and the FFNs' adaptive scales are folded into
    q/k/v and w_1: (x·s + t)·W + b = x·(diag(s)·W) + (t·W + b). In dtype
    bf16 (the compute dtype of the bf16 mode) nothing is folded, as
    masr_tpu packs it (masr_tpu/ops/pallas/squeezeformer_layer.py:229-298):
    ada is (4, 2, D), the attention's, FFN1's, the conv module's and FFN2's
    rows, and only the products' weights (attw, ffw1, ffw2, pw1w, pw2w) are
    bf16. adaptive_scale False packs identity (the reference ignores those
    parameters then)."""
    att, ffn1, ffn2, conv = (layer.self_attn, layer.ffn1, layer.ffn2,
                             layer.conv_module)
    D = layer.size
    fold = dtype == torch.float32

    def ada(m):
        if not layer.adaptive_scale:
            return (torch.ones(D, device=m.ada_scale.device),
                    torch.zeros(D, device=m.ada_scale.device))
        return m.ada_scale.reshape(-1), m.ada_bias.reshape(-1)

    def folded(m, linear):
        w = linear.weight.t()
        if not fold:
            return w, linear.bias
        s, t = ada(m)
        return s[:, None] * w, linear.bias + t @ w

    (wq, bq), (wk, bk), (wv, bv) = (folded(att, lin) for lin in (
        att.linear_q, att.linear_k, att.linear_v))
    (w1a, b1a), (w1b, b1b) = folded(ffn1, ffn1.w_1), folded(ffn2, ffn2.w_1)
    norm = conv.norm
    if isinstance(norm, torch.nn.LayerNorm):
        cnw = torch.stack([norm.weight, norm.bias])
    else:
        a = norm.weight * torch.rsqrt(norm.running_var + norm.eps)
        cnw = torch.stack([a, norm.bias - norm.running_mean * a])

    def ln(m):
        return torch.stack([m.weight, m.bias])

    packed = {
        "lnw": torch.stack([ln(layer.layer_norm1), ln(layer.layer_norm2),
                            ln(layer.layer_norm3), ln(layer.layer_norm4)]),
        "ada": torch.stack(ada(conv)) if fold else torch.stack(
            [torch.stack(ada(m)) for m in (att, ffn1, conv, ffn2)]),
        "cnw": cnw,
        "attw": torch.stack([wq, wk, wv, att.linear_out.weight.t()]),
        "vecb": torch.stack([bq, bk, bv, att.linear_out.bias, ffn1.w_2.bias,
                             ffn2.w_2.bias, conv.depthwise_conv.bias,
                             conv.pointwise_conv2.bias]),
        "posb": torch.stack([att.pos_bias_u.reshape(-1),
                             att.pos_bias_v.reshape(-1)]),
        "ffw1": torch.stack([w1a, w1b]),
        "ffb1": torch.stack([b1a, b1b]),
        "ffw2": torch.stack([ffn1.w_2.weight.t(), ffn2.w_2.weight.t()]),
        "pw1w": conv.pointwise_conv1.weight[:, :, 0].t().contiguous(),
        "pw1b": torch.stack([conv.pointwise_conv1.bias]),
        "pw2w": conv.pointwise_conv2.weight[:, :, 0].t().contiguous(),
        # torch depthwise Conv1d weight (D, 1, k) → (k, D)
        "dww": conv.depthwise_conv.weight.reshape(D, -1).t().contiguous(),
    }
    if not fold:
        for name in ("attw", "ffw1", "ffw2", "pw1w", "pw2w"):
            packed[name] = packed[name].to(dtype)
    return packed


def sq_adas(packed):
    """→ ada(v, i), the adaptive scale of sublayer i (0 attention, 1 FFN1,
    2 the conv module, 3 FFN2) on f32 rows: a folded pack (ada (2, D), the
    f32 mode) applies only the conv module's, the others being in the
    weights; an unfolded one (ada (4, 2, D), the bf16 mode) applies each."""
    ada = packed["ada"]
    if ada.dim() == 2:
        return lambda v, i: v * ada[0] + ada[1] if i == 2 else v
    return lambda v, i: v * ada[i, 0] + ada[i, 1]


def sq_layer_norms(packed, conv_ln, eps, conv_eps):
    """→ (layer_norm(v, i), conv_norm(v)) of the packed arrays: LN_i with
    eps, and the conv module's norm (LN with conv_eps, or the folded
    affine)."""
    lnw, cnw = packed["lnw"], packed["cnw"]
    D = lnw.shape[2]

    def layer_norm(v, i):
        return F.layer_norm(v, (D,), lnw[i, 0], lnw[i, 1], eps)

    def conv_norm(v):
        if conv_ln:
            return F.layer_norm(v, (D,), cnw[0], cnw[1], conv_eps)
        return v * cnw[0] + cnw[1]

    return layer_norm, conv_norm


def sq_ffn_plain(v, packed, i, ada):
    """FFN i (0: FFN1, 1: FFN2) of f32 rows, its adaptive scale through
    ada (sq_adas), its products through operand_mm. → f32."""
    h = F.silu(operand_mm(ada(v, 1 + 2 * i), packed["ffw1"][i])
               + packed["ffb1"][i])
    return operand_mm(h, packed["ffw2"][i]) + packed["vecb"][4 + i]


def fused_squeezeformer_layer_plain(x, lens, pos_p, packed, *, n_head,
                                    ksize, causal, conv_ln, eps=1e-6,
                                    conv_eps=1e-5):
    """Plain PyTorch version of the kernel, same arguments.
    x: (B, T, D) f32 or bf16; lens: (B,) valid lengths; pos_p: (T, D)
    linear_pos(pos_emb), heads along columns; packed: pack_sq_layer_params
    in x's dtype; conv_ln: the conv norm is a LayerNorm (else the folded
    BatchNorm). In the bf16 mode the activations stay f32 inside, each
    adaptive scale is applied in f32 and operands round to bf16 at each
    product (operand_mm) and in the attention. → (B, T, D) in x's
    dtype."""
    B, T, D = x.shape
    attw, vecb = packed["attw"], packed["vecb"]
    layer_norm, conv_norm = sq_layer_norms(packed, conv_ln, eps, conv_eps)
    ada, mm = sq_adas(packed), operand_mm
    cdt, x = x.dtype, x.float()
    valid = torch.arange(T, device=x.device)[None, :] \
        < lens.to(x.device)[:, None]                                # (B, T)
    row_ok = valid[:, :, None]

    xa = ada(x, 0)
    att = rel_pos_attention_plain(
        *(mm(xa, attw[i]) + vecb[i] for i in range(3)), pos_p,
        packed["posb"], valid, n_head, cdt)
    x = layer_norm(x + mm(att, attw[3]) + vecb[3], 0)
    x = layer_norm(x + sq_ffn_plain(x, packed, 0, ada), 1)
    # conv module: the rows past len enter pw1 as zeros AFTER the adaptive
    # scale, and add nothing after pw2
    xm = torch.where(row_ok, ada(x, 2), 0.0)
    acc = glu_depthwise_plain(mm(xm, packed["pw1w"]) + packed["pw1b"][0],
                              packed["pw1b"][0], packed["dww"], causal)
    y = mm(F.silu(conv_norm(acc + vecb[6])), packed["pw2w"]) + vecb[7]
    x = layer_norm(x + torch.where(row_ok, y, 0.0), 2)
    return layer_norm(x + sq_ffn_plain(x, packed, 1, ada), 3).to(cdt)


def check_sq_operands(tensors, packed, D, ksize, device, keys=SQ_PACKED_KEYS,
                      dtype=torch.float32):
    """Raise unless every tensor of {name: tensor} and packed[keys] is
    contiguous, on `device`, with pack_sq_layer_params' shapes, and of
    dtype: f32 (the training kernel's rule), or, with dtype None, the
    serving kernels' rule (chunk_layer.py check_serving_dtypes: the dtype
    of the first tensor, f32 or bf16, throughout; the LN, bias and scale
    rows f32). → (F, dtype)."""
    if dtype is None:
        dtype = check_serving_dtypes(tensors, packed, rows=SQ_SERVE_KEYS)
    F_ = packed["ffb1"].shape[1]
    want = {"lnw": (4, 2, D), "cnw": (2, D), "attw": (4, D, D),
            "vecb": (8, D), "posb": (2, D), "ffw1": (2, D, F_),
            "ffb1": (2, F_), "ffw2": (2, F_, D), "pw1w": (D, 2 * D),
            "pw1b": (1, 2 * D), "pw2w": (D, D), "dww": (ksize, D),
            "ada": (2, D) if dtype == torch.float32 else (4, 2, D)}
    for name, t in {**tensors, **{k: packed[k] for k in keys}}.items():
        if t.device != device or name not in SQ_SERVE_KEYS and \
                t.dtype != dtype or name in SQ_SERVE_KEYS and \
                t.dtype != torch.float32:
            raise ValueError(f"{name}: the kernel takes {dtype} on {device}, "
                             f"got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in want and tuple(t.shape) != want[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                             f"expected {want[name]}")
    return F_, dtype


def fused_squeezeformer_layer(x, lens, pos_p, packed, *, n_head, ksize,
                              causal, conv_ln, eps=1e-6, conv_eps=1e-5):
    """The whole full-context layer (arguments as the plain version; packed
    may also hold the serving tensor-core pack, chunk_packed_params). A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel (its
    bf16 mode for bf16 operands) or raises. → (B, T, D) in x's dtype."""
    check_serving_dtypes({"x": x, "pos_p": pos_p}, packed,
                         rows=SQ_SERVE_KEYS)
    if x.device.type == "cpu":
        return fused_squeezeformer_layer_plain(
            x, lens, pos_p, packed, n_head=n_head, ksize=ksize,
            causal=causal, conv_ln=conv_ln, eps=eps, conv_eps=conv_eps)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    B, T, D = x.shape
    packed = with_chunk_tc(packed)
    F_, dtype = check_sq_operands({"x": x, "pos_p": pos_p}, packed, D,
                                  ksize, x.device, SQ_SERVE_KEYS, None)
    check_chunk_tc(packed, D, F_, x.device, dtype)
    check_layer_args(x, lens, pos_p, n_head, ksize, causal)
    bf16 = dtype == torch.bfloat16
    fn = chunk_entry("squeezeformer_layer", "masr_sq_layer_forward"
                     + ("_bf16" if bf16 else ""),
                     3 + len(SQ_SERVE_KEYS) + len(TC_KEYS), 8, 2)
    out = torch.empty_like(x)
    M = B * T
    err = launch_tc_kernel(
        fn, (x.data_ptr(), lens.data_ptr(), pos_p.data_ptr()),
        (B, T, D, F_, n_head, ksize, int(bool(causal)), int(bool(conv_ln)),
         float(eps), float(conv_eps)), packed, SQ_SERVE_KEYS,
        full_plans(M, D, F_), M * ((3 if bf16 else 2) * D + max(F_, 4 * D)),
        out)
    if err != 0:
        raise RuntimeError(f"squeezeformer_layer kernel failed: CUDA error "
                           f"{err}")
    fused_squeezeformer_layer.launches += 1
    if bf16:
        fused_squeezeformer_layer.bf16_launches += 1
    return out


fused_squeezeformer_layer.launches = 0
fused_squeezeformer_layer.bf16_launches = 0   # the launches of its bf16 mode
