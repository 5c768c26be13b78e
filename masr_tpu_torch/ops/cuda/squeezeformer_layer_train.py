"""Squeezeformer encoder layer for training (layer_norm conv): the Hopper
kernel (forward and backward) and its plain twin.

Port of masr_tpu/ops/pallas/squeezeformer_layer_train.py
(`fused_squeezeformer_layer_train`, its `_sq_half1` / `_sq_half2`
custom-VJP ops). The CUDA source is
masr_tpu_torch/csrc/squeezeformer_layer_train.cu; its header says how the
post-norm layer is split into kernels, what the forward saves for the
backward and what bounds it on the H100.

The packed arrays are the serving kernel's (`pack_sq_layer_params` of
ops/cuda/squeezeformer_layer.py, a layer_norm conv module): the adaptive
scales of the attention and the two FFNs folded into q/k/v and w_1, the
conv module's kept apart as `ada`. Called with grad enabled, as
`SqueezeformerEncoderLayer.forward_train` calls it, the packing is
differentiable, so autograd carries the folded weights' grads on to
ada_scale and ada_bias.

`fused_squeezeformer_layer_train` runs a `torch.autograd.Function` for a
CUDA tensor: its forward launches the forward kernels, its backward the
hand-written backward kernels, and it returns a grad for x, posp and every
packed array. A CPU tensor takes `fused_squeezeformer_layer_train_plain`,
the same function in plain PyTorch with autograd as its backward. Both
draw their dropout masks from masr_tpu_torch/ops/dropout_hash.py at the
sites numbered below, so the kernel and the twin agree at any rate,
gradients included.

The bf16 mode (masr_tpu's compute dtype bf16, `cdt = x_ref.dtype`,
masr_tpu/ops/pallas/squeezeformer_layer_train.py:115, :145) takes the
unfolded pack, `pack_sq_layer_params(layer, torch.bfloat16)`: ada (4, 2,
D), each adaptive scale applied in f32 before its product rounds the
operand (a fold would move that rounding point), the products' weights
bf16. Its grads of the scales come from the kernel (the Pallas backward's
dadaw), not from autograd through a fold. x, posp and the output are
bf16; x2 and the post-norm sums s2 and s4 that masr_tpu saves in x's
dtype, the grad of x2, dx and the grads of the bf16 arrays are rounded to
bf16 (csrc/squeezeformer_layer_train.cu lists them). The plain twin
rounds at the same points with conformer_layer_train.py's `train_mm`,
`_RelScores` (through attention_train_plain) and `rounded_layer_norm`.

Launches: `fused_squeezeformer_layer_train.launches` counts one per
forward and one per backward call on a CUDA tensor (`.backward_launches`
counts the backward ones, `.bf16_launches` those of the bf16 mode,
forward and backward).
"""
import ctypes

import torch
import torch.nn.functional as F

from masr_tpu_torch.ops.cuda.conformer_layer import glu_depthwise_plain
from masr_tpu_torch.ops.cuda.conformer_layer_train import (
    BF16, attention_train_plain, rounded_layer_norm, site_dropout, train_mm)
from masr_tpu_torch.ops.cuda.squeezeformer_layer import (SQ_PACKED_KEYS,
                                                         check_sq_operands,
                                                         sq_adas,
                                                         sq_layer_norms)
from masr_tpu_torch.ops.dropout_hash import dropout_params

# dropout sites, as csrc/squeezeformer_layer_train.cu numbers them (the
# Conformer's numbering, FFN1 in the macaron FFN's place)
SITE_FFN1_HIDDEN, SITE_FFN1_OUT, SITE_ATT_PROB, SITE_ATT_OUT, \
    SITE_CONV_OUT, SITE_FFN2_HIDDEN, SITE_FFN2_OUT = range(7)


def fused_squeezeformer_layer_train_plain(x, mask, seeds, lens, posp, packed,
                                          *, layer, n_head, ksize, causal,
                                          rate=0.0, att_rate=0.0, eps=1e-6,
                                          conv_eps=1e-5, row0=0):
    """Plain PyTorch version of the kernel, same arguments. x: (B, T, D)
    f32, or bf16 with posp bf16 and the unfolded bf16 pack (the bf16 mode,
    the module docstring; any other dtype computes as f32 does); mask: (B,
    T, T) bool attention mask (chunk and padding); seeds:
    (B,) int32, this layer's per-utterance dropout seeds; lens: (B,) valid
    lengths; posp: (T, D) linear_pos(pos_emb); packed:
    `pack_sq_layer_params` of a layer_norm conv layer; layer: the layer's
    index (a dropout-hash key); rate: dropout at the FFN hidden rows and
    at every sublayer's output; att_rate: at the attention probabilities;
    eps: the four layer LayerNorms'; conv_eps: the conv module's; row0:
    the global batch row of utterance 0 (a dropout-hash key). →
    (B, T, D)."""
    B, T, D = x.shape
    bf16 = x.dtype == BF16
    mm = train_mm if bf16 else torch.matmul
    x = x.float() if bf16 else x
    # the adaptive scale of sublayer i: the folded pack (f32) applies only
    # the conv module's, the unfolded one (bf16) each
    ada = sq_adas(packed)
    lnw, attw, vecb = packed["lnw"], packed["attw"], packed["vecb"]
    layer_norm, conv_norm = sq_layer_norms(packed, True, eps, conv_eps)
    drop = site_dropout(seeds, layer, T, x.device, row0)
    row_ok = (torch.arange(T, device=x.device)[None, :]
              < lens.to(x.device)[:, None])[:, :, None]

    def ffn(v, i, site_h, site_o):
        h = drop(F.silu(mm(v, packed["ffw1"][i]) + packed["ffb1"][i]),
                 site_h, rate)
        return drop(mm(h, packed["ffw2"][i]) + vecb[4 + i], site_o, rate)

    def post_norm(v, i):
        """LN_i; bf16 mode: its backward reads bf16(v)'s statistics and
        its output is rounded (masr_tpu saves v and returns x2 and y in x's
        dtype)"""
        if not bf16:
            return layer_norm(v, i)
        return rounded_layer_norm(v, lnw[i, 0], lnw[i, 1], eps).to(BF16)

    xa = ada(x, 0)
    att = attention_train_plain(
        *(mm(xa, attw[i]) + vecb[i] for i in range(3)), posp,
        packed["posb"], mask, n_head, seeds, layer, att_rate, row0)
    x = layer_norm(x + drop(mm(att, attw[3]) + vecb[3], SITE_ATT_OUT, rate),
                   0)
    x = post_norm(x + ffn(ada(x, 1), 0, SITE_FFN1_HIDDEN, SITE_FFN1_OUT), 1)
    x = x.float() if bf16 else x
    # conv module: the rows past len enter pw1 as zeros AFTER the adaptive
    # scale, and add nothing after pw2
    xm = torch.where(row_ok, ada(x, 2), 0.0)
    acc = glu_depthwise_plain(mm(xm, packed["pw1w"]) + packed["pw1b"][0],
                              packed["pw1b"][0], packed["dww"], causal)
    y = mm(F.silu(conv_norm(acc + vecb[6])), packed["pw2w"]) + vecb[7]
    x = layer_norm(
        x + torch.where(row_ok, drop(y, SITE_CONV_OUT, rate), 0.0), 2)
    return post_norm(x + ffn(ada(x, 3), 1, SITE_FFN2_HIDDEN, SITE_FFN2_OUT),
                     3)


def _lib():
    from masr_tpu_torch.ops.cuda import build
    lib = build.load("squeezeformer_layer_train")
    P, I, U, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, \
        ctypes.c_float
    for name in ("masr_sq_layer_train_saved_floats",
                 "masr_sq_layer_train_scratch_floats"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_size_t
        fn.argtypes = [I] * 6
    for name in ("masr_sq_layer_train_forward",
                 "masr_sq_layer_train_forward_bf16"):
        fn = getattr(lib, name)
        fn.restype = I
        fn.argtypes = [P] * 20 + [I] * 9 + [U, Fl, U, Fl, Fl, Fl, P]
    fn = lib.masr_sq_layer_train_backward
    fn.restype = I
    fn.argtypes = [P] * 32 + [I] * 9 + [U, Fl, U, Fl, P]
    fn = lib.masr_sq_layer_train_backward_bf16
    fn.restype = I
    fn.argtypes = [P] * 25 + [I] * 9 + [U, Fl, U, Fl, P]
    return lib


# the backward's inputs among the packed arrays, in the C entry's order (f32
# mode, after x, seeds, lens and posp; the bf16 mode reads x, posp and the
# product weights from the forward's f32 copies in `saved`)
_BWD_KEYS = ("lnw", "ada", "cnw", "attw", "ffw1", "ffw2", "pw1w", "pw1b",
             "pw2w", "dww")
_BWD_KEYS_BF16 = ("lnw", "ada", "cnw", "pw1b", "dww")


class _TrainLayer(torch.autograd.Function):
    """Forward and backward through the CUDA kernels; the inputs after
    (cfg, mask, seeds, lens) are x, posp and the packed arrays in
    SQ_PACKED_KEYS order."""

    @staticmethod
    def forward(ctx, cfg, mask, seeds, lens, x, posp, *params):
        lib = _lib()
        B, T, D = x.shape
        F_ = params[SQ_PACKED_KEYS.index("ffw1")].shape[2]
        dims = (B, T, D, F_, cfg["n_head"])
        bf16 = x.dtype == BF16
        saved = torch.empty(lib.masr_sq_layer_train_saved_floats(
            *dims, bf16), dtype=torch.float32, device=x.device)
        out = torch.empty_like(x)
        entry = lib.masr_sq_layer_train_forward_bf16 if bf16 else \
            lib.masr_sq_layer_train_forward
        with torch.cuda.device(x.device):
            err = entry(
                x.data_ptr(), mask.data_ptr(), seeds.data_ptr(),
                lens.data_ptr(), posp.data_ptr(),
                *(p.data_ptr() for p in params), out.data_ptr(),
                saved.data_ptr(), *dims, cfg["ksize"], cfg["causal"],
                cfg["layer"], cfg["row0"], *cfg["drop"], *cfg["att_drop"],
                cfg["eps"],
                cfg["conv_eps"],
                torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"squeezeformer_layer_train forward kernel "
                               f"failed: CUDA error {err}")
        fused_squeezeformer_layer_train.launches += 1
        fused_squeezeformer_layer_train.bf16_launches += bf16
        ctx.cfg, ctx.dims, ctx.saved, ctx.bf16 = cfg, dims, saved, bf16
        ctx.save_for_backward(x, seeds, lens, posp, *params)
        return out

    @staticmethod
    def backward(ctx, dy):
        lib = _lib()
        x, seeds, lens, posp, *params = ctx.saved_tensors
        packed = dict(zip(SQ_PACKED_KEYS, params))
        cfg, dims, bf16 = ctx.cfg, ctx.dims, ctx.bf16
        dy = dy.contiguous()
        scratch = torch.empty(lib.masr_sq_layer_train_scratch_floats(
            *dims, bf16), dtype=torch.float32, device=dy.device)
        dx, dposp = torch.empty_like(dy), torch.empty_like(posp)
        grads = [torch.empty_like(p) for p in params]
        inputs = [seeds, lens] + [packed[k] for k in _BWD_KEYS_BF16] \
            if bf16 else [x, seeds, lens, posp] + [packed[k]
                                                   for k in _BWD_KEYS]
        entry = lib.masr_sq_layer_train_backward_bf16 if bf16 else \
            lib.masr_sq_layer_train_backward
        with torch.cuda.device(dy.device):
            err = entry(
                dy.data_ptr(), *(t.data_ptr() for t in inputs),
                ctx.saved.data_ptr(), scratch.data_ptr(), dx.data_ptr(),
                dposp.data_ptr(), *(g.data_ptr() for g in grads), *dims,
                cfg["ksize"], cfg["causal"], cfg["layer"], cfg["row0"],
                *cfg["drop"],
                *cfg["att_drop"],
                torch.cuda.current_stream(dy.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"squeezeformer_layer_train backward kernel "
                               f"failed: CUDA error {err}")
        fused_squeezeformer_layer_train.launches += 1
        fused_squeezeformer_layer_train.backward_launches += 1
        fused_squeezeformer_layer_train.bf16_launches += bf16
        return (None, None, None, None, dx, dposp, *grads)


def fused_squeezeformer_layer_train(x, mask, seeds, lens, posp, packed, *,
                                    layer, n_head, ksize, causal, rate=0.0,
                                    att_rate=0.0, eps=1e-6, conv_eps=1e-5,
                                    row0=0):
    """The whole training layer, differentiable in x, posp and the packed
    arrays. A CPU tensor takes the plain version; a CUDA tensor launches
    the kernels (their bf16 mode for bf16 operands and the unfolded bf16
    pack) or raises. Arguments as the plain version. → (B, T, D) in x's
    dtype."""
    if x.device.type == "cpu":
        return fused_squeezeformer_layer_train_plain(
            x, mask, seeds, lens, posp, packed, layer=layer, n_head=n_head,
            ksize=ksize, causal=causal, rate=rate, att_rate=att_rate,
            eps=eps, conv_eps=conv_eps, row0=row0)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    B, T, D = x.shape
    x, posp = x.contiguous(), posp.contiguous()
    packed = {k: packed[k].contiguous() for k in SQ_PACKED_KEYS}
    check_sq_operands({"x": x, "posp": posp}, packed, D, ksize, x.device,
                      dtype=None)
    if tuple(posp.shape) != (T, D):
        raise ValueError(f"posp: shape {tuple(posp.shape)}, expected "
                         f"{(T, D)}")
    if lens.dtype != torch.int32 or lens.device != x.device or \
            tuple(lens.shape) != (B,):
        raise ValueError("lens must be (B,) int32 on the device of x")
    if D % n_head:
        raise ValueError(f"d_model {D} is not a multiple of {n_head} heads")
    if not causal and ksize % 2 == 0:
        raise ValueError("non-causal conv needs an odd kernel size")
    mask = mask.to(torch.uint8).contiguous()
    if tuple(mask.shape) != (B, T, T) or mask.device != x.device:
        raise ValueError(f"mask must be (B, T, T) = {(B, T, T)} on "
                         f"{x.device}, got {tuple(mask.shape)}")
    if seeds.dtype != torch.int32 or tuple(seeds.shape) != (B,) or \
            seeds.device != x.device:
        raise ValueError("seeds must be (B,) int32 on the device of x")
    if not 0 <= layer < 4096 or not 0 <= row0 or row0 + B >= 65536:
        raise ValueError("the dropout hash keys layer < 4096, row0 + B < "
                         "65536")
    cfg = {"n_head": n_head, "ksize": ksize, "causal": int(bool(causal)),
           "layer": int(layer), "row0": int(row0),
           "drop": dropout_params(rate),
           "att_drop": dropout_params(att_rate), "eps": float(eps),
           "conv_eps": float(conv_eps)}
    return _TrainLayer.apply(cfg, mask, seeds.contiguous(), lens, x, posp,
                             *(packed[k] for k in SQ_PACKED_KEYS))


fused_squeezeformer_layer_train.launches = 0
fused_squeezeformer_layer_train.backward_launches = 0
fused_squeezeformer_layer_train.bf16_launches = 0   # fwd + bwd, bf16 mode
