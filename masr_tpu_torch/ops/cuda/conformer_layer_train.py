"""Conformer encoder layer for training: the Hopper kernel (forward and
backward) and its plain twin.

Port of masr_tpu/ops/pallas/conformer_layer_train.py
(`fused_conformer_layer_train`, its `_half1` / `_half2` custom-VJP ops).
The CUDA source is masr_tpu_torch/csrc/conformer_layer_train.cu; its header
says how the layer is split into kernels, what the forward saves for the
backward and what bounds it on the H100.

`fused_conformer_layer_train` runs a `torch.autograd.Function` for a CUDA
tensor: its forward launches the forward kernels, its backward the
hand-written backward kernels, and it returns a grad for x, for posp (the
linear_pos product, left to autograd outside) and for every packed weight
array, so the packing (`pack_layer_params`, differentiable when called
with grad enabled) carries the grads on to the layer's parameters. A CPU
tensor takes `fused_conformer_layer_train_plain`, the same function in
plain PyTorch with autograd as its backward. Both draw their dropout masks
from masr_tpu_torch/ops/dropout_hash.py, so the kernel and the plain twin
agree at any rate, gradients included.

The operands are f32, or bf16: the bf16 mode of masr_tpu's kernel at
compute dtype bf16 (`cdt = x_ref.dtype`,
masr_tpu/ops/pallas/conformer_layer_train.py:171): x, posp, the output and
the products' weights bf16 (`pack_layer_params(layer, torch.bfloat16)`),
the LN, bias, depthwise and position-bias rows f32, every product of
bf16-rounded operands summed in f32 (`_mm`, :79-95) in the forward and in
the hand-written backward, and x2 (the second half's input), x4 (the final
LN's input as half 2 saves it), their grads on the way back, dx and the
grads of the bf16 arrays rounded to bf16 where masr_tpu stores x's dtype
(csrc/conformer_layer_train.cu lists them). The plain twin reproduces
those rounding points on any device: `train_mm` rounds a product's
operands, then multiplies in f32, and its backward rounds the incoming
grad and the other operand the same way; `_RelScores` is the attention
scores' product with masr_tpu's dq operand bf16(k + posp); `_RoundedLN`
the final LN whose backward reads the statistics of bf16(x4).

Launches: `fused_conformer_layer_train.launches` counts one per forward
and one per backward call on a CUDA tensor (`.backward_launches` counts the
backward ones, `.bf16_launches` those of the bf16 mode, forward and
backward).
"""
import ctypes
import math

import torch
import torch.nn.functional as F

from masr_tpu_torch.ops.cuda.conformer_layer import (MASK_VALUE, PACKED_KEYS,
                                                     check_packed)
from masr_tpu_torch.ops.cuda.rel_pos_attention import rounded
from masr_tpu_torch.ops.dropout_hash import dropout_mask, dropout_params

BF16 = torch.bfloat16

# dropout sites, as csrc/conformer_layer_train.cu numbers them
SITE_MACARON_HIDDEN, SITE_MACARON_OUT, SITE_ATT_PROB, SITE_ATT_OUT, \
    SITE_CONV_OUT, SITE_FFN_HIDDEN, SITE_FFN_OUT = range(7)


def site_dropout(seeds, layer, T, device, row0=0):
    """→ drop(v, site, rate): v (B, T, N) times the hash's dropout mask of
    `site` over rows t < T and columns n < N (identity at rate 0);
    utterance b keyed as row0 + b."""
    rows = torch.arange(T, device=device)

    def drop(v, site, rate):
        if rate <= 0.0:
            return v
        return v * dropout_mask(seeds, layer, site, rows, torch.arange(
            v.shape[-1], device=device), rate, row0)

    return drop


class _TrainMM(torch.autograd.Function):
    """a @ b of bf16-rounded operands summed in f32 (masr_tpu's _mm at cdt
    bf16); the backward rounds the incoming grad and the other operand the
    same way: da = bf16(g) @ bf16(b)^T, db = bf16(a)^T @ bf16(g), each
    summed in f32 (a weight's grad over every row), returned in the
    operand's dtype (a bf16 weight's grad rounded once). b: a (K, N) weight
    or a batch of a's batch."""

    @staticmethod
    def forward(ctx, a, b):
        ar, br = rounded(a, BF16), rounded(b, BF16)
        ctx.save_for_backward(ar, br)
        return ar @ br

    @staticmethod
    def backward(ctx, g):
        ar, br = ctx.saved_tensors
        gr = rounded(g, BF16)
        da = gr @ br.transpose(-1, -2)
        if br.dim() == 2:
            db = ar.reshape(-1, ar.shape[-1]).t() @ gr.reshape(
                -1, gr.shape[-1])
        else:
            db = ar.transpose(-1, -2) @ gr
        return da, db


def train_mm(a, b):
    """The bf16 mode's product (_TrainMM): → f32."""
    return _TrainMM.apply(a, b)


class _RelScores(torch.autograd.Function):
    """The bf16 mode's attention scores (AC + BD) / sqrt(d_k) of q, k (B, h,
    T, d_k) f32, posp (T, D) bf16 and posb (2, D) f32, as masr_tpu's kernel
    computes them and their grads: bf16(q + u) . bf16(k)^T + bf16(q + v) .
    posp^T in f32; backward with dS = bf16(g / sqrt(d_k)): dq = dS .
    bf16(k + posp) (the sum rounded as one operand), dk = dS^T . bf16(q +
    u), dposp = the sum over b of dS^T . bf16(q + v), and the position
    biases' grads the column sums of dS . bf16(k) and dS . posp."""

    @staticmethod
    def forward(ctx, q, k, posp, posb, scale):
        H, d_k = q.shape[1], q.shape[3]
        T = posp.shape[0]
        p = posp.float().view(T, H, d_k).transpose(0, 1)
        bu = posb[0].view(H, 1, d_k)
        bv = posb[1].view(H, 1, d_k)
        qu, qv, kr = rounded(q + bu, BF16), rounded(q + bv, BF16), \
            rounded(k, BF16)
        ctx.save_for_backward(qu, qv, k, kr, p)
        ctx.scale = scale
        return (qu @ kr.transpose(-1, -2) + qv @ p.transpose(-1, -2)) * scale

    @staticmethod
    def backward(ctx, g):
        qu, qv, k, kr, p = ctx.saved_tensors
        H, T, d_k = p.shape
        ds = rounded(g * ctx.scale, BF16)
        dq = ds @ rounded(k + p, BF16)
        dk = ds.transpose(-1, -2) @ qu
        dp = (ds.transpose(-1, -2) @ qv).sum(0)
        dbu = (ds @ kr).sum((0, 2)).reshape(-1)
        dbv = (ds @ p).sum((0, 2)).reshape(-1)
        return (dq, dk, dp.transpose(0, 1).reshape(T, H * d_k),
                torch.stack([dbu, dbv]), None)


class _RoundedLN(torch.autograd.Function):
    """LayerNorm of f32 rows x whose backward reads the statistics of
    bf16(x): masr_tpu's kernel saves the post-norm input in x's dtype and
    re-derives the statistics from it (the Conformer's x4, the
    Squeezeformer's s2 and s4). → f32."""

    @staticmethod
    def forward(ctx, x, w, b, eps):
        ctx.save_for_backward(rounded(x, BF16), w, b)
        ctx.eps = eps
        return F.layer_norm(x, (x.shape[-1],), w, b, eps)

    @staticmethod
    def backward(ctx, g):
        xr, w, b = ctx.saved_tensors
        with torch.enable_grad():
            xr, w, b = (t.detach().requires_grad_(True) for t in (xr, w, b))
            y = F.layer_norm(xr, (xr.shape[-1],), w, b, ctx.eps)
            dx, dw, db = torch.autograd.grad(y, (xr, w, b), g)
        return dx, dw, db, None


def rounded_layer_norm(x, w, b, eps):
    """_RoundedLN: → f32."""
    return _RoundedLN.apply(x, w, b, eps)


def attention_train_plain(q, k, v, posp, posb, mask, n_head, seeds, layer,
                          att_rate, row0=0):
    """The training layers' rel-pos MHSA core over a (B, T, T) bool mask
    (a query row with no visible key gives 0), AC + BD as one 2·d_k
    product, dropout at the probabilities (site SITE_ATT_PROB, rows
    h·T + t1). q, k, v: (B, T, D) projections, heads along columns; posp:
    (T, D), bf16 in the bf16 mode (the scores through _RelScores, P.V
    through train_mm); posb: (2, D) pos_bias_u, pos_bias_v. → (B, T, D)
    before the out projection."""
    B, T, D = q.shape
    d_k = D // n_head
    dev = q.device
    bf16 = posp.dtype == BF16
    q, k, v = (t.view(B, T, n_head, d_k).transpose(1, 2) for t in (q, k, v))
    if bf16:
        s = _RelScores.apply(q, k, posp, posb, 1.0 / math.sqrt(d_k))
    else:
        p = posp.view(T, n_head, d_k).transpose(0, 1)[None]
        bu = posb[0].view(n_head, 1, d_k)
        bv = posb[1].view(n_head, 1, d_k)
        qcat = torch.cat([q + bu, q + bv], dim=-1)
        kcat = torch.cat([k, p.expand(B, -1, -1, -1)], dim=-1)
        s = (qcat @ kcat.transpose(-1, -2)) * (1.0 / math.sqrt(d_k))
    m = mask.to(dev, torch.bool)[:, None]
    s = torch.where(m, s, MASK_VALUE)
    prob = torch.where(m, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = prob.sum(-1, keepdim=True)
    pr = prob / torch.where(l == 0.0, 1.0, l)
    if att_rate > 0.0:
        rows = torch.arange(n_head * T, device=dev)
        pr = pr * dropout_mask(seeds, layer, SITE_ATT_PROB, rows,
                               torch.arange(T, device=dev),
                               att_rate, row0).view(B, n_head, T, T)
    o = train_mm(pr, v) if bf16 else pr @ v
    return o.transpose(1, 2).reshape(B, T, D)


def fused_conformer_layer_train_plain(x, mask, seeds, lens, posp, packed, *,
                                      layer, n_head, ksize, causal,
                                      ff_scale=0.5, rate=0.0, att_rate=0.0,
                                      eps=1e-5, row0=0):
    """Plain PyTorch version of the kernel, same arguments. x: (B, T, D)
    f32, or bf16 with posp and the pack's product weights bf16 (the bf16
    mode, rounded as the module docstring says; any other dtype computes
    as f32 does); mask: (B, T, T) bool attention mask (chunk and padding);
    seeds:
    (B,) int32, this layer's per-utterance dropout seeds; lens: (B,) valid
    lengths; posp: (T, D) linear_pos(pos_emb); packed: `pack_layer_params`;
    layer: the layer's index (a dropout-hash key); rate: dropout at the
    FFN hidden and output, attention output and conv output; att_rate: at
    the attention probabilities; row0: the global batch row of utterance 0
    (a dropout-hash key: a row draws its masks whichever rank runs it). →
    (B, T, D)."""
    B, T, D = x.shape
    bf16 = x.dtype == BF16
    mm = train_mm if bf16 else torch.matmul
    x = x.float() if bf16 else x
    lnw, vecb, attw = packed["lnw"], packed["vecb"], packed["attw"]
    dev = x.device
    t_idx = torch.arange(T, device=dev)
    drop = site_dropout(seeds, layer, T, dev, row0)

    def layer_norm(v, i):
        return F.layer_norm(v, (D,), lnw[i, 0], lnw[i, 1], eps)

    def ffn(v, i, site_h, site_o):
        h = drop(F.silu(mm(v, packed["ffw1"][i]) + packed["ffb1"][i]),
                 site_h, rate)
        return drop(mm(h, packed["ffw2"][i]) + vecb[i], site_o, rate)

    row_ok = (t_idx[None, :] < lens.to(dev)[:, None])[:, :, None]
    x = x + ff_scale * ffn(layer_norm(x, 0), 0, SITE_MACARON_HIDDEN,
                           SITE_MACARON_OUT)

    xn = layer_norm(x, 1)
    att = attention_train_plain(
        *(mm(xn, attw[i]) + vecb[2 + i] for i in range(3)), posp,
        packed["posb"], mask, n_head, seeds, layer, att_rate, row0)
    x = x + drop(mm(att, attw[3]) + vecb[5], SITE_ATT_OUT, rate)
    if bf16:
        x = x.to(BF16).float()    # x2, the second half's input

    # conv module; causal pad rows carry GLU(pw1 bias), non-causal pads 0
    xm = torch.where(row_ok, layer_norm(x, 2), 0.0)
    gx = mm(xm, packed["pw1w"]) + packed["pw1b"][0]
    u = gx[..., :D] * torch.sigmoid(gx[..., D:])
    pw1b = packed["pw1b"][0]
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
        acc = acc + upad[:, i:i + T] * packed["dww"][i]
    y = mm(F.silu(layer_norm(acc + vecb[6], 3)), packed["pw2w"]) + vecb[7]
    x = x + torch.where(row_ok, drop(y, SITE_CONV_OUT, rate), 0.0)

    x = x + ff_scale * ffn(layer_norm(x, 4), 1, SITE_FFN_HIDDEN,
                           SITE_FFN_OUT)
    if bf16:
        return rounded_layer_norm(x, lnw[5, 0], lnw[5, 1], eps).to(BF16)
    return layer_norm(x, 5)


def _lib():
    from masr_tpu_torch.ops.cuda import build
    lib = build.load("conformer_layer_train")
    P, I, U, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, \
        ctypes.c_float
    for name in ("masr_conformer_layer_train_saved_floats",
                 "masr_conformer_layer_train_scratch_floats"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_size_t
        fn.argtypes = [I] * 6
    for name in ("masr_conformer_layer_train_forward",
                 "masr_conformer_layer_train_forward_bf16"):
        fn = getattr(lib, name)
        fn.restype = I
        fn.argtypes = [P] * 18 + [I] * 9 + [U, Fl, U, Fl, Fl, Fl, P]
    fn = lib.masr_conformer_layer_train_backward
    fn.restype = I
    fn.argtypes = [P] * 27 + [I] * 9 + [U, Fl, U, Fl, Fl, P]
    fn = lib.masr_conformer_layer_train_backward_bf16
    fn.restype = I
    fn.argtypes = [P] * 21 + [I] * 9 + [U, Fl, U, Fl, Fl, P]
    return lib


# the backward's inputs among the packed arrays, in the C entry's order (f32
# mode; the bf16 mode reads the product weights and posp from the
# forward's f32 copies in `saved`)
_BWD_KEYS = ("lnw", "ffw1", "ffw2", "attw", "pw1w", "pw1b", "pw2w", "dww")
_BWD_KEYS_BF16 = ("lnw", "pw1b", "dww")


class _TrainLayer(torch.autograd.Function):
    """Forward and backward through the CUDA kernels; the inputs after
    (cfg, mask, seeds, lens) are x, posp and the packed arrays in
    PACKED_KEYS order."""

    @staticmethod
    def forward(ctx, cfg, mask, seeds, lens, x, posp, *params):
        lib = _lib()
        B, T, D = x.shape
        F_ = params[PACKED_KEYS.index("ffw1")].shape[2]
        dims = (B, T, D, F_, cfg["n_head"])
        bf16 = x.dtype == BF16
        saved = torch.empty(lib.masr_conformer_layer_train_saved_floats(
            *dims, bf16), dtype=torch.float32, device=x.device)
        out = torch.empty_like(x)
        entry = lib.masr_conformer_layer_train_forward_bf16 if bf16 else \
            lib.masr_conformer_layer_train_forward
        with torch.cuda.device(x.device):
            err = entry(
                x.data_ptr(), mask.data_ptr(), seeds.data_ptr(),
                lens.data_ptr(), posp.data_ptr(),
                *(p.data_ptr() for p in params), out.data_ptr(),
                saved.data_ptr(), *dims, cfg["ksize"], cfg["causal"],
                cfg["layer"], cfg["row0"], *cfg["drop"], *cfg["att_drop"],
                cfg["ff_scale"], cfg["eps"],
                torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"conformer_layer_train forward kernel "
                               f"failed: CUDA error {err}")
        fused_conformer_layer_train.launches += 1
        fused_conformer_layer_train.bf16_launches += bf16
        ctx.cfg, ctx.dims, ctx.saved, ctx.bf16 = cfg, dims, saved, bf16
        ctx.save_for_backward(seeds, lens, posp, *params)
        return out

    @staticmethod
    def backward(ctx, dy):
        lib = _lib()
        seeds, lens, posp, *params = ctx.saved_tensors
        packed = dict(zip(PACKED_KEYS, params))
        cfg, dims, bf16 = ctx.cfg, ctx.dims, ctx.bf16
        dy = dy.contiguous()
        scratch = torch.empty(lib.masr_conformer_layer_train_scratch_floats(
            *dims, bf16), dtype=torch.float32, device=dy.device)
        dx, dposp = torch.empty_like(dy), torch.empty_like(posp)
        grads = [torch.empty_like(p) for p in params]
        inputs = [packed[k] for k in _BWD_KEYS_BF16] if bf16 else \
            [posp] + [packed[k] for k in _BWD_KEYS]
        entry = lib.masr_conformer_layer_train_backward_bf16 if bf16 else \
            lib.masr_conformer_layer_train_backward
        with torch.cuda.device(dy.device):
            err = entry(
                dy.data_ptr(), seeds.data_ptr(), lens.data_ptr(),
                *(t.data_ptr() for t in inputs),
                ctx.saved.data_ptr(), scratch.data_ptr(), dx.data_ptr(),
                dposp.data_ptr(), *(g.data_ptr() for g in grads), *dims,
                cfg["ksize"], cfg["causal"], cfg["layer"], cfg["row0"],
                *cfg["drop"], *cfg["att_drop"], cfg["ff_scale"],
                torch.cuda.current_stream(dy.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"conformer_layer_train backward kernel "
                               f"failed: CUDA error {err}")
        fused_conformer_layer_train.launches += 1
        fused_conformer_layer_train.backward_launches += 1
        fused_conformer_layer_train.bf16_launches += bf16
        return (None, None, None, None, dx, dposp, *grads)


def fused_conformer_layer_train(x, mask, seeds, lens, posp, packed, *,
                                layer, n_head, ksize, causal, ff_scale=0.5,
                                rate=0.0, att_rate=0.0, eps=1e-5, row0=0):
    """The whole training layer, differentiable in x, posp and the packed
    arrays. A CPU tensor takes the plain version; a CUDA tensor launches
    the kernels (their bf16 mode for bf16 operands) or raises. Arguments as
    the plain version. → (B, T, D) in x's dtype."""
    if x.device.type == "cpu":
        return fused_conformer_layer_train_plain(
            x, mask, seeds, lens, posp, packed, layer=layer, n_head=n_head,
            ksize=ksize, causal=causal, ff_scale=ff_scale, rate=rate,
            att_rate=att_rate, eps=eps, row0=row0)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    B, T, _ = x.shape
    x, posp = x.contiguous(), posp.contiguous()
    packed = {k: packed[k].contiguous() for k in PACKED_KEYS}
    check_packed(x, lens, posp, packed, n_head, ksize, causal)
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
           "att_drop": dropout_params(att_rate),
           "ff_scale": float(ff_scale), "eps": float(eps)}
    return _TrainLayer.apply(cfg, mask, seeds.contiguous(), lens, x, posp,
                             *(packed[k] for k in PACKED_KEYS))


fused_conformer_layer_train.launches = 0
fused_conformer_layer_train.backward_launches = 0
fused_conformer_layer_train.bf16_launches = 0   # fwd + bwd of its bf16 mode
