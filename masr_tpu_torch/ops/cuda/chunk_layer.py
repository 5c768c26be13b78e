"""Streaming chunk step of a Conformer layer: the Hopper kernel and its plain
twin.

Port of masr_tpu/ops/pallas/chunk_layer.py (`fused_chunk_layer`,
`make_chunk_pos_table`, `clamp_pos_starts`). The CUDA source is
masr_tpu_torch/csrc/chunk_layer.cu; its header gives the state layout (a
single-copy att-cache ring per layer with per-slot write pointers, in place
of the TPU's mirrored ring and right-aligned rolled cache), what bounds the
kernel on the H100 and what is left for later.

`fused_chunk_layer` launches the kernel for CUDA tensors and takes the plain
PyTorch version, `fused_chunk_layer_plain`, only for CPU tensors. Both
update the att and cnn caches in place for active slots and leave inactive
slots' caches untouched. It counts its kernel launches in
`fused_chunk_layer.launches`, one per layer call. Operands are f32.

The kernel's products (and those of the Squeezeformer chunk kernel) run on
the tensor cores in 3xTF32 with a split of K that depends on N and K alone
(`split_plan`), so a slot's bits do not depend on how many slots share the
call. Their weights come from the serving tensor-core pack
(`pack_chunk_tc`): each weight split once into its TF32 halves, W_q, W_k,
W_v side by side. A layer caches it with its serving pack
(`chunk_packed_params`), which the full-context layer kernels read too
(conformer_layer.py, squeezeformer_layer.py); a kernel takes a pack
without it too, and then builds it for the call.
"""
import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from masr_tpu_torch.models.embedding import sinusoid_position_encoding
from masr_tpu_torch.ops.cuda.rel_pos_attention import MASK_VALUE
from masr_tpu_torch.ops.cuda.tf32 import split_tf32

K_TILE = 32          # the products' k-tile depth (csrc/common.cuh kTcBK)
# the chunk kernels' products in their plans' order (csrc/serving.cuh
# ChunkProduct): name, N and K as functions of (D, F)
CHUNK_PRODUCTS = (("ffn_w1", lambda D, F_: (F_, D)),
                  ("ffn_w2", lambda D, F_: (D, F_)),
                  ("qkv", lambda D, F_: (3 * D, D)),
                  ("out", lambda D, F_: (D, D)),
                  ("pw1", lambda D, F_: (2 * D, D)),
                  ("pw2", lambda D, F_: (D, D)))
TC_KEYS = ("tc_ffw1", "tc_ffw2", "tc_qkv", "tc_out", "tc_pw1", "tc_pw2")
# the serving pack's arrays that the Conformer serving kernels (chunk and
# full context) read besides TC_KEYS, in their C argument order
CHUNK_KEYS = ("lnw", "ffb1", "vecb", "posb", "pw1b", "dww")


def _halves(w):
    """(.., K, N) f32 → (.., 2, K, N): its TF32 big and small halves."""
    big, small = split_tf32(w.contiguous())
    return torch.stack([big, small], dim=-3).contiguous()


def pack_chunk_tc(packed):
    """The serving tensor-core pack of a chunk layer, from its serving pack
    (pack_layer_params or pack_sq_layer_params: the same product weights):
    each product's weight (K, N) as its TF32 halves (2, K, N), big then
    small, so the kernels split only the activations. tc_qkv holds [W_q |
    W_k | W_v] (D, 3D): q, k and v are one product. → {TC_KEYS: f32}:
    tc_ffw1 (2, 2, D, F), tc_ffw2 (2, 2, F, D), tc_qkv (2, D, 3D), tc_out,
    tc_pw2 (2, D, D), tc_pw1 (2, D, 2D)."""
    attw = packed["attw"]
    return {"tc_ffw1": _halves(packed["ffw1"]),
            "tc_ffw2": _halves(packed["ffw2"]),
            "tc_qkv": _halves(torch.cat([attw[0], attw[1], attw[2]], dim=1)),
            "tc_out": _halves(attw[3]),
            "tc_pw1": _halves(packed["pw1w"]),
            "tc_pw2": _halves(packed["pw2w"])}


def with_chunk_tc(packed):
    """packed with the serving tensor-core pack: as given if it holds one
    (chunk_packed_params), else extended by pack_chunk_tc for this call."""
    if all(k in packed for k in TC_KEYS):
        return packed
    return {**packed, **pack_chunk_tc(packed)}


def split_plan(N, K):
    """How the chunk kernels split the K of a product of width N: (parts,
    part), part a multiple of K_TILE, part s covering k in [s·part,
    min((s + 1)·part, K)). A function of N and K alone, never of the rows
    M, so each output element is summed in the same order at any number of
    slots. The fewest parts (a power of two, at most one per k-tile) that
    give ~96 blocks of 8 columns on one 16-row tile (predict_stream's
    grid; the engine's 512 rows fill 64 x 64 tiles): at the flagship's
    widths FFN w_2, out and pw2 take 4 parts, pw1 2, the rest 1."""
    k_tiles = -(-K // K_TILE)
    parts = 1
    while -(-N // 8) * parts < 96 and parts * 2 <= k_tiles:
        parts *= 2
    part = -(-k_tiles // parts) * K_TILE
    return -(-K // part), part


@functools.lru_cache(maxsize=64)
def chunk_plans(B, c, D, F_, ksize):
    """The wrapper's arguments for one chunk-layer call's products: their
    plans (ChunkProduct order, flattened (parts, part) pairs), and the
    floats of the split products' partial sums and the counters of their
    output tiles (16 x 8, the smallest tile) that the call needs. Cached
    per shape."""
    M, rows_pw1 = B * c, B * (ksize - 1 + c)
    plans, n_partials, n_counters = (), 0, 0
    for name, nk in CHUNK_PRODUCTS:
        N, K = nk(D, F_)
        parts, part = split_plan(N, K)
        plans += (parts, part)
        rows = rows_pw1 if name == "pw1" else M
        if parts > 1:
            n_partials = max(n_partials, parts * rows * N)
            n_counters = max(n_counters, -(-rows // 16) * -(-N // 8))
    return plans, n_partials, n_counters


def check_chunk_tc(packed, D, F_, device):
    """Raises unless packed holds the serving tensor-core pack of a layer
    of width D and FFN F_, f32, contiguous, on device."""
    want = {"tc_ffw1": (2, 2, D, F_), "tc_ffw2": (2, 2, F_, D),
            "tc_qkv": (2, D, 3 * D), "tc_out": (2, D, D),
            "tc_pw1": (2, D, 2 * D), "tc_pw2": (2, D, D)}
    for name, shape in want.items():
        t = packed[name]
        if t.device != device or t.dtype != torch.float32 or \
                not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"{name}: the kernel takes contiguous f32 "
                             f"{shape} on {device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def launch_tc_kernel(fn, lead, tail, packed, keys, plans, n_ws, out):
    """Calls a serving kernel's C entry fn with lead (its pointer arguments
    before the weights), the weights packed[keys] and the tensor-core pack,
    the plans, out, the scratch (n_ws floats of workspace, then the split
    products' partials and tile counters; allocated here), tail (its
    scalars) and the current stream. plans: (the plans as a ctypes int
    array or a flat tuple, n_partials, n_counters). → CUDA error code."""
    plans, n_partials, n_counters = plans
    if not isinstance(plans, ctypes.Array):
        plans = (ctypes.c_int * len(plans))(*plans)
    device = out.device
    scratch = torch.empty(n_ws + n_partials + n_counters,
                          dtype=torch.float32, device=device)
    ptr = scratch.data_ptr()
    with torch.cuda.device(device):
        return fn(*lead, *(packed[k].data_ptr() for k in keys + TC_KEYS),
                  plans, out.data_ptr(), ptr, ptr + 4 * n_ws, n_partials,
                  ptr + 4 * (n_ws + n_partials), n_counters, *tail,
                  torch.cuda.current_stream(device).cuda_stream)


def launch_chunk_kernel(fn, lead, tail, packed, keys, B, c, D, F_, ksize,
                        device):
    """Calls the chunk kernel's C entry fn (launch_tc_kernel) with its plans
    and workspace. → (CUDA error code, output (B, c, D))."""
    M, W = B * c, ksize - 1 + c
    out = torch.empty(B, c, D, dtype=torch.float32, device=device)
    err = launch_tc_kernel(fn, lead, tail, packed, keys,
                           chunk_plans(B, c, D, F_, ksize),
                           M * (3 * D + max(F_, 4 * D)) + B * W * 3 * D, out)
    return err, out


@functools.lru_cache(maxsize=None)
def chunk_entry(name, symbol, n_ptrs, n_ints, n_floats):
    """The C entry `symbol` of a serving kernel csrc/<name>.cu (built at
    first use), typed for ctypes once (typed_entry)."""
    from masr_tpu_torch.ops.cuda import build
    return typed_entry(getattr(build.load(name), symbol), n_ptrs, n_ints,
                       n_floats)


def typed_entry(fn, n_ptrs, n_ints, n_floats):
    """fn, a serving kernel's C entry, typed for ctypes: n_ptrs pointers
    (operands and weights), the plans, out, workspace, partials and their
    count, counters and their count, n_ints ints, n_floats floats, the
    stream. → fn."""
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.restype = i
    fn.argtypes = ([p] * n_ptrs
                   + [ctypes.POINTER(i), p, p, p, ctypes.c_longlong, p, i]
                   + [i] * n_ints + [ctypes.c_float] * n_floats + [p])
    return fn


def make_chunk_pos_table(wpos, cache_size, table_len=8192):
    """Per-layer position table: row i = linear_pos(sinusoid(max(i - C,
    0))), wpos the torch linear_pos weight (D, D). For a slot at offset o,
    rows [o, o + C + c) are exactly the positions max(o - C + j, 0) that
    the exact route computes, so the kernel reads one window per slot.
    → (table_len, D) f32 on the device of wpos."""
    positions = torch.clamp(
        torch.arange(table_len, device=wpos.device) - cache_size, min=0)
    return sinusoid_position_encoding(positions, wpos.shape[1]) @ wpos.t()


def clamp_pos_starts(offsets, table_len, L):
    """Per-slot start rows into a make_chunk_pos_table table: offsets past
    table_len - L clamp (positions freeze there; the engine moves such
    slots to exact positions before they get there). → (B,) int32."""
    hi = table_len - L
    if hi < 0:
        raise ValueError(f"position table too short: table_len={table_len} "
                         f"< window L={L} (C + c)")
    return offsets.clamp(0, hi).to(torch.int32)


def _shapes(x, att_cache, cnn_cache, n_head, ksize, n_sub):
    B, c, D = x.shape
    C = att_cache.shape[2]
    if D % n_head or D // n_head > 128:
        raise ValueError(f"d_model {D} with {n_head} heads: the kernel takes "
                         "d_k = D / heads up to 128")
    if tuple(att_cache.shape) != (B, n_head, C, 2 * (D // n_head)):
        raise ValueError(f"att_cache: shape {tuple(att_cache.shape)}, "
                         f"expected {(B, n_head, C, 2 * (D // n_head))}")
    if ksize < 2 or tuple(cnn_cache.shape) != (B, ksize - 1, D):
        raise ValueError(f"cnn_cache: shape {tuple(cnn_cache.shape)}, "
                         f"expected {(B, ksize - 1, D)} (causal conv, k >= 2)")
    if n_sub < 1 or c % n_sub or (n_sub > 1 and c > C):
        raise ValueError(f"n_sub={n_sub} needs n_sub | c ({c}) and c <= C "
                         f"({C})")
    return B, c, D, C


def ring_attention_plain(q, k, v, pos, pos_starts, att_cache, cache_lens,
                         wptrs, posb, *, n_head, n_sub=1, rep=1):
    """Rel-pos attention of the chunk rows over [att cache ‖ chunk], AC +
    BD as one 2·d_k contraction. q, k, v: (B, c, D), heads along columns;
    pos: (rows, D) linear_pos(sinusoid) rows, slot s reads rows
    pos_starts[s] + j for j < L = C + c; att_cache: (B, h, C·rep, 2·d_k)
    ring of C logical rows, logical row p in memory rows p·rep .. p·rep +
    rep - 1 (read from the last), chronological row j at logical row
    (wptrs[s] + j) mod C, valid iff j >= C - cache_lens[s]; n_sub > 1:
    block-causal over n_sub sub-chunks. → (B, c, D)."""
    B, c, D = q.shape
    dev = q.device
    d_k = D // n_head
    ring = att_cache[:, :, rep - 1::rep]
    C = ring.shape[2]
    L, sub_c = C + c, c // n_sub
    q, k, v = (t.view(B, c, n_head, d_k).transpose(1, 2) for t in (q, k, v))
    wp = wptrs.to(dev, torch.long) % max(C, 1)
    ring_rows = (wp[:, None] + torch.arange(C, device=dev)) % max(C, 1)
    chron = ring.gather(2, ring_rows[:, None, :, None].expand(
        B, n_head, C, 2 * d_k))
    keys = torch.cat([chron[..., :d_k], k], dim=2)            # (B, h, L, dk)
    vals = torch.cat([chron[..., d_k:], v], dim=2)
    rows = pos_starts.to(dev, torch.long)[:, None] \
        + torch.arange(L, device=dev)
    p = pos[rows].view(B, L, n_head, d_k).transpose(1, 2)
    bu = posb[0].view(n_head, 1, d_k)
    bv = posb[1].view(n_head, 1, d_k)
    s = (torch.cat([q + bu, q + bv], dim=-1)
         @ torch.cat([keys, p], dim=-1).transpose(-1, -2)) / math.sqrt(d_k)
    # cache key j valid iff j >= C - cache_len (and j >= i·sub_c for
    # sub-chunk i); chunk keys of sub-chunks <= i
    sub = torch.arange(c, device=dev) // sub_c                      # (c,)
    col = torch.arange(L, device=dev)
    clen = cache_lens.to(dev, torch.long).clamp(0, C)
    cache_ok = ((col < C)[None, None, :]
                & (col[None, None, :] >= (C - clen)[:, None, None])
                & (col[None, :] >= sub[:, None] * sub_c)[None])
    chunk_ok = (col[None, :] >= C) & (col[None, :] - C
                                      < (sub[:, None] + 1) * sub_c)
    ok = (cache_ok | chunk_ok[None])[:, None]                # (B, 1, c, L)
    s = torch.where(ok, s, MASK_VALUE)
    prob = torch.where(ok, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = prob.sum(-1, keepdim=True)
    att = (prob / torch.where(l == 0.0, 1.0, l)) @ vals
    return att.transpose(1, 2).reshape(B, c, D)


def write_ring_plain(att_cache, k, v, wptrs, active, *, n_head, rep=1):
    """The fresh K/V rows k, v (B, c, D) into the ring (layout as
    ring_attention_plain), in place: fresh row i at logical row (wptrs[s] +
    i) mod C, every copy of it; only the last C rows when c > C; slots with
    active[s] False untouched."""
    B, c, D = k.shape
    C = att_cache.shape[2] // rep
    if not C:
        return
    dev, d_k = k.device, D // n_head
    first = max(c - C, 0)
    wp = wptrs.to(dev, torch.long) % C
    dst = (wp[:, None] + torch.arange(first, c, device=dev)) % C
    fresh = torch.cat([k.view(B, c, n_head, d_k), v.view(B, c, n_head, d_k)],
                      dim=-1).transpose(1, 2)[:, :, first:]
    act = active.to(dev).bool()[:, None, None, None]
    for r in range(rep):
        idx = (dst * rep + r)[:, None, :, None].expand(B, n_head, c - first,
                                                        2 * d_k)
        att_cache.scatter_(2, idx, torch.where(act, fresh,
                                               att_cache.gather(2, idx)))


def glu_valid_depthwise_plain(gx, dww):
    """Conv-module middle of the chunk layers: GLU of the pointwise_conv1
    output gx (B, k-1+c, 2D) of [cnn cache ‖ chunk], then the VALID
    depthwise conv over time without its bias, dww (k, D). → (B, c, D)."""
    D, ksize = gx.shape[2] // 2, dww.shape[0]
    c = gx.shape[1] - ksize + 1
    u = gx[..., :D] * torch.sigmoid(gx[..., D:])
    acc = torch.zeros_like(u[:, :c])
    for i in range(ksize):
        acc = acc + u[:, i:i + c] * dww[i]
    return acc


def fused_chunk_layer_plain(x, pos, pos_starts, att_cache, cnn_cache,
                            cache_lens, wptrs, active, packed, *, n_head,
                            ksize, n_sub=1, ff_scale=0.5, eps=1e-5):
    """Plain PyTorch version of the kernel, same arguments.
    x: (B, c, D) chunk after subsampling; pos: (rows, D) linear_pos(sinusoid)
    rows, slot s reads rows pos_starts[s] + j for j < L = C + c;
    att_cache: (B, h, C, 2·d_k) ring, chronological row j at physical row
    (wptrs[s] + j) mod C, valid iff j >= C - cache_lens[s]; cnn_cache:
    (B, k-1, D); active: (B,) bool or int; packed: pack_layer_params.
    n_sub > 1: block-causal over n_sub sub-chunks (equal to n_sub
    sequential steps). Updates the caches of active slots in place.
    → (B, c, D)."""
    B, c, D, C = _shapes(x, att_cache, cnn_cache, n_head, ksize, n_sub)
    lnw, vecb, attw = packed["lnw"], packed["vecb"], packed["attw"]

    def layer_norm(v, i):
        return F.layer_norm(v, (D,), lnw[i, 0], lnw[i, 1], eps)

    def ffn(v, i):
        h = F.silu(v @ packed["ffw1"][i] + packed["ffb1"][i])
        return h @ packed["ffw2"][i] + vecb[i]

    x = x + ff_scale * ffn(layer_norm(x, 0), 0)

    # rel-pos MHSA over [cache ‖ chunk]
    xn = layer_norm(x, 1)
    q, k, v = (xn @ attw[i] + vecb[2 + i] for i in range(3))
    att = ring_attention_plain(q, k, v, pos, pos_starts, att_cache,
                               cache_lens, wptrs, packed["posb"],
                               n_head=n_head, n_sub=n_sub)
    x = x + att @ attw[3] + vecb[5]

    # causal conv over [cnn cache ‖ LN(x)] (cache rows are pre-pointwise)
    cin = torch.cat([cnn_cache, layer_norm(x, 2)], dim=1)     # (B, k-1+c, D)
    acc = glu_valid_depthwise_plain(cin @ packed["pw1w"] + packed["pw1b"][0],
                                    packed["dww"])
    x = x + F.silu(layer_norm(acc + vecb[6], 3)) @ packed["pw2w"] + vecb[7]

    x = x + ff_scale * ffn(layer_norm(x, 4), 1)
    out = layer_norm(x, 5)

    # caches, active slots only: the fresh K/V rows; the last k-1 rows of
    # the conv input
    act = active.to(x.device).bool()
    write_ring_plain(att_cache, k, v, wptrs, act, n_head=n_head)
    cnn_cache.copy_(torch.where(act[:, None, None], cin[:, c:], cnn_cache))
    return out


def _check(x, pos, pos_starts, att_cache, cnn_cache, cache_lens, wptrs,
           active, packed, ksize):
    B, c, D = x.shape
    F_ = packed["ffb1"].shape[1]
    want = {"lnw": (6, 2, D), "ffb1": (2, F_), "vecb": (8, D),
            "posb": (2, D), "pw1b": (1, 2 * D), "dww": (ksize, D)}
    floats = {"x": x, "pos": pos, "att_cache": att_cache,
              "cnn_cache": cnn_cache, **{k: packed[k] for k in CHUNK_KEYS}}
    for name, t in floats.items():
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(f"{name}: the kernel takes f32 on {x.device}, "
                             f"got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in want and tuple(t.shape) != want[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                             f"expected {want[name]}")
    check_chunk_tc(packed, D, F_, x.device)
    if pos.dim() != 2 or pos.shape[1] != D:
        raise ValueError(f"pos: shape {tuple(pos.shape)}, expected (rows, "
                         f"{D})")
    for name, t in (("pos_starts", pos_starts), ("cache_lens", cache_lens),
                    ("wptrs", wptrs), ("active", active)):
        if t.dtype != torch.int32 or t.device != x.device or \
                tuple(t.shape) != (B,) or not t.is_contiguous():
            raise ValueError(f"{name} must be (B,) int32 on the device of x")
    return F_


def fused_chunk_layer(x, pos, pos_starts, att_cache, cnn_cache, cache_lens,
                      wptrs, active, packed, *, n_head, ksize, n_sub=1,
                      ff_scale=0.5, eps=1e-5):
    """One streaming step of the layer over B slots (arguments as
    fused_chunk_layer_plain; packed may also hold the serving tensor-core
    pack, chunk_packed_params). A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises. The caller keeps every
    pos_starts[s] + C + c within the rows of pos (clamp_pos_starts does).
    → (B, c, D) f32; the caches of active slots are updated in place."""
    B, c, D, C = _shapes(x, att_cache, cnn_cache, n_head, ksize, n_sub)
    if x.device.type == "cpu":
        return fused_chunk_layer_plain(
            x, pos, pos_starts, att_cache, cnn_cache, cache_lens, wptrs,
            active, packed, n_head=n_head, ksize=ksize, n_sub=n_sub,
            ff_scale=ff_scale, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    active = active.to(torch.int32)
    packed = with_chunk_tc(packed)
    F_ = _check(x, pos, pos_starts, att_cache, cnn_cache, cache_lens, wptrs,
                active, packed, ksize)
    fn = chunk_entry("chunk_layer", "masr_chunk_layer_forward",
                     8 + len(CHUNK_KEYS) + len(TC_KEYS), 8, 2)
    lead = (x.data_ptr(), pos.data_ptr(), pos_starts.data_ptr(),
            att_cache.data_ptr(), cnn_cache.data_ptr(),
            cache_lens.data_ptr(), wptrs.data_ptr(), active.data_ptr())
    err, out = launch_chunk_kernel(
        fn, lead, (B, c, C, D, F_, n_head, ksize, n_sub, float(ff_scale),
                   float(eps)), packed, CHUNK_KEYS, B, c, D, F_, ksize,
        x.device)
    if err != 0:
        raise RuntimeError(f"chunk_layer kernel failed: CUDA error {err}")
    fused_chunk_layer.launches += 1
    return out


fused_chunk_layer.launches = 0
