"""Full-context Squeezeformer encoder layer: the Hopper kernel and its plain
twin.

Port of masr_tpu/ops/pallas/squeezeformer_layer.py
(`fused_squeezeformer_layer`, `pack_sq_layer_params`). The CUDA source is masr_tpu_torch/csrc/
squeezeformer_layer.cu; its header says how the post-norm layer is split
into kernels, what bounds it on the H100 and what is left for later.

`fused_squeezeformer_layer` launches the kernel for a CUDA tensor and takes
the plain PyTorch version, `fused_squeezeformer_layer_plain`, only for a CPU
tensor. It counts its kernel launches in `fused_squeezeformer_layer.launches`,
one per layer call. Operands are f32.
"""
import ctypes

import torch
import torch.nn.functional as F

from masr_tpu_torch.ops.cuda.conformer_layer import (glu_depthwise_plain,
                                                     rel_pos_attention_plain)

SQ_PACKED_KEYS = ("lnw", "ada", "cnw", "attw", "vecb", "posb", "ffw1",
                  "ffb1", "ffw2", "pw1w", "pw1b", "pw2w", "dww")


def pack_sq_layer_params(layer):
    """One SqueezeformerEncoderLayer (masr_tpu_torch.models.squeezeformer)
    → the kernels' f32 arrays, matmul weights as (in, out):
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
    The attention's and the FFNs' adaptive scales are folded into q/k/v and
    w_1: (x·s + t)·W + b = x·(diag(s)·W) + (t·W + b). adaptive_scale False
    packs identity (the reference ignores those parameters then)."""
    att, ffn1, ffn2, conv = (layer.self_attn, layer.ffn1, layer.ffn2,
                             layer.conv_module)
    D = layer.size

    def ada(m):
        if not layer.adaptive_scale:
            return (torch.ones(D, device=m.ada_scale.device),
                    torch.zeros(D, device=m.ada_scale.device))
        return m.ada_scale.reshape(-1), m.ada_bias.reshape(-1)

    def folded(m, linear):
        s, t = ada(m)
        w = linear.weight.t()
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

    return {
        "lnw": torch.stack([ln(layer.layer_norm1), ln(layer.layer_norm2),
                            ln(layer.layer_norm3), ln(layer.layer_norm4)]),
        "ada": torch.stack(ada(conv)),
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


def sq_ffn_plain(v, packed, i):
    """FFN i (0: FFN1, 1: FFN2) with its adaptive scale folded in."""
    h = F.silu(v @ packed["ffw1"][i] + packed["ffb1"][i])
    return h @ packed["ffw2"][i] + packed["vecb"][4 + i]


def fused_squeezeformer_layer_plain(x, lens, pos_p, packed, *, n_head,
                                    ksize, causal, conv_ln, eps=1e-6,
                                    conv_eps=1e-5):
    """Plain PyTorch version of the kernel, same arguments.
    x: (B, T, D) f32; lens: (B,) valid lengths; pos_p: (T, D)
    linear_pos(pos_emb), heads along columns; packed: pack_sq_layer_params;
    conv_ln: the conv norm is a LayerNorm (else the folded BatchNorm).
    → (B, T, D)."""
    B, T, D = x.shape
    attw, vecb = packed["attw"], packed["vecb"]
    layer_norm, conv_norm = sq_layer_norms(packed, conv_ln, eps, conv_eps)
    valid = torch.arange(T, device=x.device)[None, :] \
        < lens.to(x.device)[:, None]                                # (B, T)
    row_ok = valid[:, :, None]

    att = rel_pos_attention_plain(
        *(x @ attw[i] + vecb[i] for i in range(3)), pos_p, packed["posb"],
        valid, n_head)
    x = layer_norm(x + att @ attw[3] + vecb[3], 0)
    x = layer_norm(x + sq_ffn_plain(x, packed, 0), 1)
    # conv module: the rows past len enter pw1 as zeros AFTER the adaptive
    # scale, and add nothing after pw2
    ada = packed["ada"]
    xm = torch.where(row_ok, x * ada[0] + ada[1], 0.0)
    acc = glu_depthwise_plain(xm @ packed["pw1w"] + packed["pw1b"][0],
                              packed["pw1b"][0], packed["dww"], causal)
    y = F.silu(conv_norm(acc + vecb[6])) @ packed["pw2w"] + vecb[7]
    x = layer_norm(x + torch.where(row_ok, y, 0.0), 2)
    return layer_norm(x + sq_ffn_plain(x, packed, 1), 3)


def check_sq_operands(tensors, packed, D, ksize, device):
    """Raise unless every array is f32, contiguous, on `device`, and the
    packed arrays have pack_sq_layer_params' shapes."""
    F_ = packed["ffw1"].shape[2]
    want = {"lnw": (4, 2, D), "ada": (2, D), "cnw": (2, D),
            "attw": (4, D, D), "vecb": (8, D), "posb": (2, D),
            "ffw1": (2, D, F_), "ffb1": (2, F_), "ffw2": (2, F_, D),
            "pw1w": (D, 2 * D), "pw1b": (1, 2 * D), "pw2w": (D, D),
            "dww": (ksize, D)}
    for name, t in {**tensors, **{k: packed[k] for k in SQ_PACKED_KEYS}
                    }.items():
        if t.device != device or t.dtype != torch.float32:
            raise ValueError(f"{name}: the kernel takes f32 on {device}, "
                             f"got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in want and tuple(t.shape) != want[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                             f"expected {want[name]}")
    return F_


def fused_squeezeformer_layer(x, lens, pos_p, packed, *, n_head, ksize,
                              causal, conv_ln, eps=1e-6, conv_eps=1e-5):
    """The whole full-context layer (arguments as the plain version). A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises. → (B, T, D) f32."""
    if x.device.type == "cpu":
        return fused_squeezeformer_layer_plain(
            x, lens, pos_p, packed, n_head=n_head, ksize=ksize,
            causal=causal, conv_ln=conv_ln, eps=eps, conv_eps=conv_eps)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    B, T, D = x.shape
    F_ = check_sq_operands({"x": x, "pos_p": pos_p}, packed, D, ksize,
                           x.device)
    if tuple(pos_p.shape) != (T, D):
        raise ValueError(f"pos_p: shape {tuple(pos_p.shape)}, "
                         f"expected {(T, D)}")
    if lens.dtype != torch.int32 or lens.device != x.device or \
            tuple(lens.shape) != (B,):
        raise ValueError("lens must be (B,) int32 on the device of x")
    if D % n_head or D // n_head > 128:
        raise ValueError(f"d_model {D} with {n_head} heads: the kernel "
                         "takes d_k = D / heads up to 128")
    if not causal and ksize % 2 == 0:
        raise ValueError("non-causal conv needs an odd kernel size")
    from masr_tpu_torch.ops.cuda import build
    lib = build.load("squeezeformer_layer")
    fn = lib.masr_sq_layer_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 18 + [ctypes.c_int] * 8
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    out = torch.empty_like(x)
    workspace = torch.empty(B * T * (2 * D + max(F_, 4 * D)),
                            dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), lens.data_ptr(), pos_p.data_ptr(),
                 *(packed[k].data_ptr() for k in SQ_PACKED_KEYS),
                 out.data_ptr(), workspace.data_ptr(), B, T, D, F_, n_head,
                 ksize, int(bool(causal)), int(bool(conv_ln)), float(eps),
                 float(conv_eps), torch.cuda.current_stream(x.device)
                 .cuda_stream)
    if err != 0:
        raise RuntimeError(f"squeezeformer_layer kernel failed: CUDA error "
                           f"{err}")
    fused_squeezeformer_layer.launches += 1
    return out


fused_squeezeformer_layer.launches = 0
