"""Streaming chunk step of a Squeezeformer layer: the Hopper kernel and its
plain twin.

Port of masr_tpu/ops/pallas/chunk_layer_sq.py (`fused_chunk_layer_sq`). The
CUDA source is masr_tpu_torch/csrc/chunk_layer_sq.cu; its header gives the
state layout (the Conformer chunk kernel's single-copy att ring with
per-slot write pointers, whose half-rate layers keep each row twice at full
resolution), what bounds the kernel on the H100 and what is left for later.

`fused_chunk_layer_sq` launches the kernel for CUDA tensors and takes the
plain PyTorch version, `fused_chunk_layer_sq_plain`, only for CPU tensors.
Its products run as the Conformer chunk kernel's (chunk_layer.py: the
split plan and the serving tensor-core pack).
Both update the att and cnn caches in place for active slots and leave
inactive slots' caches untouched. It counts its kernel launches in
`fused_chunk_layer_sq.launches`, one per layer call. Operands are f32.
"""

import torch
import torch.nn.functional as F

from masr_tpu_torch.ops.cuda.chunk_layer import (TC_KEYS, check_chunk_tc,
                                                 chunk_entry,
                                                 glu_valid_depthwise_plain,
                                                 launch_chunk_kernel,
                                                 ring_attention_plain,
                                                 with_chunk_tc,
                                                 write_ring_plain)
from masr_tpu_torch.ops.cuda.squeezeformer_layer import (check_sq_operands,
                                                         sq_ffn_plain,
                                                         sq_layer_norms)


def _shapes(x, att_cache, cnn_cache, n_head, ksize, n_sub, rep):
    B, c, D = x.shape
    if D % n_head or D // n_head > 128:
        raise ValueError(f"d_model {D} with {n_head} heads: the kernel takes "
                         "d_k = D / heads up to 128")
    rows = att_cache.shape[2]
    if rep < 1 or rows % rep or tuple(att_cache.shape) != (
            B, n_head, rows, 2 * (D // n_head)):
        raise ValueError(f"att_cache: shape {tuple(att_cache.shape)}, "
                         f"expected (B={B}, {n_head}, C·rep (rep={rep}), "
                         f"{2 * (D // n_head)})")
    C = rows // rep
    if ksize < 2 or tuple(cnn_cache.shape) != (B, ksize - 1, D):
        raise ValueError(f"cnn_cache: shape {tuple(cnn_cache.shape)}, "
                         f"expected {(B, ksize - 1, D)} (causal conv, k >= 2)")
    if n_sub < 1 or c % n_sub or (n_sub > 1 and c > C):
        raise ValueError(f"n_sub={n_sub} needs n_sub | c ({c}) and c <= C "
                         f"({C})")
    return B, c, D, C


def fused_chunk_layer_sq_plain(x, pos, pos_starts, att_cache, cnn_cache,
                               cache_lens, wptrs, active, packed, *, n_head,
                               ksize, conv_ln, n_sub=1, rep=1, eps=1e-6,
                               conv_eps=1e-5):
    """Plain PyTorch version of the kernel, same arguments.
    x: (B, c, D) chunk at the layer's rate; pos: (rows, D)
    linear_pos(sinusoid) rows, slot s reads rows pos_starts[s] + j for j <
    L = C + c; att_cache: (B, h, C·rep, 2·d_k) ring of C logical rows at the
    layer's rate, each stored rep times (rep = 2: a half-rate layer on the
    full-resolution cache), chronological row j at logical row (wptrs[s] +
    j) mod C, valid iff j >= C - cache_lens[s] (cache_lens and wptrs at the
    layer's rate); cnn_cache: (B, k-1, D) post-ada conv input rows; active:
    (B,) bool or int; packed: pack_sq_layer_params. n_sub > 1: block-causal
    over n_sub sub-chunks (equal to n_sub sequential steps). Updates the
    caches of active slots in place. → (B, c, D)."""
    B, c, D, C = _shapes(x, att_cache, cnn_cache, n_head, ksize, n_sub, rep)
    attw, vecb, ada = packed["attw"], packed["vecb"], packed["ada"]
    layer_norm, conv_norm = sq_layer_norms(packed, conv_ln, eps, conv_eps)

    q, k, v = (x @ attw[i] + vecb[i] for i in range(3))
    att = ring_attention_plain(q, k, v, pos, pos_starts, att_cache,
                               cache_lens, wptrs, packed["posb"],
                               n_head=n_head, n_sub=n_sub, rep=rep)
    x = layer_norm(x + att @ attw[3] + vecb[3], 0)
    x = layer_norm(x + sq_ffn_plain(x, packed, 0), 1)
    # causal conv over [cnn cache ‖ ada(x)] (cache rows are post-ada,
    # pre-pointwise)
    cin = torch.cat([cnn_cache, x * ada[0] + ada[1]], dim=1)  # (B, k-1+c, D)
    acc = glu_valid_depthwise_plain(cin @ packed["pw1w"] + packed["pw1b"][0],
                                    packed["dww"])
    y = F.silu(conv_norm(acc + vecb[6])) @ packed["pw2w"] + vecb[7]
    x = layer_norm(x + y, 2)
    out = layer_norm(x + sq_ffn_plain(x, packed, 1), 3)

    # caches, active slots only
    act = active.to(x.device).bool()
    write_ring_plain(att_cache, k, v, wptrs, act, n_head=n_head, rep=rep)
    cnn_cache.copy_(torch.where(act[:, None, None], cin[:, c:], cnn_cache))
    return out


# the serving pack's arrays that the kernel reads besides TC_KEYS
SQ_CHUNK_KEYS = ("lnw", "ada", "cnw", "vecb", "posb", "ffb1", "pw1b", "dww")


def fused_chunk_layer_sq(x, pos, pos_starts, att_cache, cnn_cache,
                         cache_lens, wptrs, active, packed, *, n_head, ksize,
                         conv_ln, n_sub=1, rep=1, eps=1e-6, conv_eps=1e-5):
    """One streaming step of the layer over B slots (arguments as
    fused_chunk_layer_sq_plain; packed may also hold the serving
    tensor-core pack, chunk_packed_params). A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises. The caller keeps
    every pos_starts[s] + C + c within the rows of pos. → (B, c, D) f32;
    the caches of active slots are updated in place."""
    B, c, D, C = _shapes(x, att_cache, cnn_cache, n_head, ksize, n_sub, rep)
    if x.device.type == "cpu":
        return fused_chunk_layer_sq_plain(
            x, pos, pos_starts, att_cache, cnn_cache, cache_lens, wptrs,
            active, packed, n_head=n_head, ksize=ksize, conv_ln=conv_ln,
            n_sub=n_sub, rep=rep, eps=eps, conv_eps=conv_eps)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    active = active.to(torch.int32)
    packed = with_chunk_tc(packed)
    F_ = check_sq_operands({"x": x, "pos": pos, "att_cache": att_cache,
                            "cnn_cache": cnn_cache}, packed, D, ksize,
                           x.device)
    check_chunk_tc(packed, D, F_, x.device)
    if pos.dim() != 2 or pos.shape[1] != D:
        raise ValueError(f"pos: shape {tuple(pos.shape)}, expected (rows, "
                         f"{D})")
    for name, t in (("pos_starts", pos_starts), ("cache_lens", cache_lens),
                    ("wptrs", wptrs), ("active", active)):
        if t.dtype != torch.int32 or t.device != x.device or \
                tuple(t.shape) != (B,) or not t.is_contiguous():
            raise ValueError(f"{name} must be (B,) int32 on the device of x")
    fn = chunk_entry("chunk_layer_sq", "masr_chunk_layer_sq_forward",
                     8 + len(SQ_CHUNK_KEYS) + len(TC_KEYS), 10, 2)
    lead = (x.data_ptr(), pos.data_ptr(), pos_starts.data_ptr(),
            att_cache.data_ptr(), cnn_cache.data_ptr(),
            cache_lens.data_ptr(), wptrs.data_ptr(), active.data_ptr())
    err, out = launch_chunk_kernel(
        fn, lead, (B, c, C, rep, D, F_, n_head, ksize, n_sub,
                   int(bool(conv_ln)), float(eps), float(conv_eps)),
        packed, SQ_CHUNK_KEYS, B, c, D, F_, ksize, x.device)
    if err != 0:
        raise RuntimeError(f"chunk_layer_sq kernel failed: CUDA error {err}")
    fused_chunk_layer_sq.launches += 1
    return out


fused_chunk_layer_sq.launches = 0
