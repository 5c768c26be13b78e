"""Masked rel-pos flash attention: the Hopper kernel and its plain twin.

Port of masr_tpu/ops/pallas/attention.py (`rel_pos_flash_attention` and
`rel_pos_attention_reference`). The CUDA source is masr_tpu_torch/csrc/
rel_pos_attention.cu: a pre-pass reduces the mask to a map of 64 x 64 tiles
(hidden, full, partial; `mask_tile_map_plain` is its plain twin), then a
flash kernel runs both products on the tensor cores in 3xTF32, skipping
hidden tiles (csrc/flash_attention.cuh; the full-context layer kernels run
it with a key-length mask, whose tiles `length_tile_map_plain` gives); its
header says what bounds it on the H100.

`rel_pos_flash_attention` launches the kernels for CUDA tensors and takes
the plain PyTorch version, `rel_pos_attention_plain`, only for CPU tensors.
It counts its launches in `rel_pos_flash_attention.launches`, one per call
on the card (the pre-pass and the attention are one call). The kernel reads
every operand through its strides: q, k, v may be (B, T, D) rows viewed as
(B, H, T, d_k) heads, p the matching (H, T, d_k) view of
linear_pos(pos_emb), and the mask any (B, T, T) view, a broadcast `expand`
included (it is never read as if it were dense). Only a view whose last
axis is not unit-stride is copied first. The output has q's layout. f32
only, d_k <= 128; no backward (the Pallas kernel has none).
"""
import ctypes
import math

import torch

MASK_VALUE = -0.7 * torch.finfo(torch.float32).max


def rel_pos_attention_plain(q, k, v, p, bias_u, bias_v, mask, sm_scale=None):
    """Plain PyTorch version, the Pallas kernel's semantics: q, k, v (B, H,
    T, d); p (H, T, d); bias_u, bias_v (H, d); mask (B, T, T) bool, True =
    attend. Masked scores take MASK_VALUE and their probabilities are
    zeroed, so a row that sees no key gives 0. → (B, H, T, d)."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if sm_scale is None else sm_scale
    q_cat = torch.cat([q + bias_u[None, :, None, :],
                       q + bias_v[None, :, None, :]], dim=-1)
    k_cat = torch.cat([k, p[None].expand(k.shape[0], -1, -1, -1)], dim=-1)
    s = (q_cat @ k_cat.transpose(-1, -2)) * scale
    m = mask[:, None].to(torch.bool)
    s = torch.where(m, s, MASK_VALUE)
    prob = torch.where(m, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = prob.sum(-1, keepdim=True)
    return (prob / torch.where(l == 0.0, 1.0, l)) @ v


TILE = 64                                     # the kernel's map tile
HIDDEN, FULL, PARTIAL = 0, 1, 2


def mask_tile_map_plain(mask, tile=TILE):
    """Plain twin of the kernel's pre-pass: the (B, T, T) mask (nonzero =
    attend) reduced to a (B, nt, nt) uint8 map of tile x tile blocks, nt =
    ceil(T / tile): HIDDEN (0) where no pair of the block is seen, FULL (1)
    where every pair inside [0, T) is, PARTIAL (2) otherwise. Tests use it;
    the kernel computes its own."""
    B, T, _ = mask.shape
    nt = -(-T // tile)
    pad = nt * tile - T
    seen = torch.nn.functional.pad((mask != 0).to(torch.int32),
                                   (0, pad, 0, pad))
    inside = torch.nn.functional.pad(
        torch.ones(T, T, dtype=torch.int32, device=mask.device),
        (0, pad, 0, pad))

    def blocks(x):
        return x.reshape(-1, nt, tile, nt, tile).sum((2, 4))
    n_seen, n_inside = blocks(seen), blocks(inside)
    out = torch.full((B, nt, nt), PARTIAL, dtype=torch.uint8,
                     device=mask.device)
    out[n_seen == 0] = HIDDEN
    out[n_seen == n_inside.expand_as(n_seen)] = FULL
    return out


def length_tile_map_plain(lens, T, tile=TILE):
    """Plain twin of the tile kinds that the full-context layers' key-length
    mask gives the flash kernel (csrc/flash_attention.cuh kLengthMask): every
    query row of utterance b sees the keys col < lens[b], so each query
    tile's row of the (B, nt, nt) uint8 map is the same: HIDDEN where the
    key tile's first key is >= len, FULL where its last key is < len,
    PARTIAL otherwise. The kernel computes these from lens itself (no
    pre-pass); tests hold this map to mask_tile_map_plain of the expanded
    length mask."""
    lens = torch.as_tensor(lens).to(torch.long).clamp(0, T)
    nt = -(-T // tile)
    first = torch.arange(nt, device=lens.device) * tile
    last = torch.clamp(first + tile, max=T) - 1
    kinds = torch.full((len(lens), nt), PARTIAL, dtype=torch.uint8,
                       device=lens.device)
    kinds[first[None] >= lens[:, None]] = HIDDEN
    kinds[last[None] < lens[:, None]] = FULL
    return kinds[:, None, :].expand(len(lens), nt, nt).contiguous()


def _unit_columns(t):
    return t if t.stride(-1) == 1 else t.contiguous()


def _check(q, k, v, p, bias_u, bias_v, mask):
    B, H, T, d = q.shape
    want = {"q": (B, H, T, d), "k": (B, H, T, d), "v": (B, H, T, d),
            "p": (H, T, d), "bias_u": (H, d), "bias_v": (H, d),
            "mask": (B, T, T)}
    for name, t in (("q", q), ("k", k), ("v", v), ("p", p),
                    ("bias_u", bias_u), ("bias_v", bias_v), ("mask", mask)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{want[name]}")
        if name != "mask" and t.dtype != torch.float32:
            raise ValueError(f"{name}: the kernel takes f32, got {t.dtype}")
    if not 1 <= d <= 128:
        raise ValueError(f"d_k {d}: the kernel takes d_k up to 128")


def rel_pos_flash_attention(q, k, v, p, bias_u, bias_v, mask, sm_scale=None,
                            tile_map_out=None):
    """softmax(mask(((q+bu)·kᵀ + (q+bv)·pᵀ)·sm_scale))·v, sm_scale 1/√d by
    default. q, k, v (B, H, T, d) f32; p (H, T, d); bias_u, bias_v (H, d);
    mask (B, T, T) bool (True = attend). A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises. → (B, H, T, d)
    f32, in q's memory layout; 0 on rows with no visible key.
    tile_map_out: a contiguous (B, nt, nt) uint8 CUDA tensor, nt =
    ceil(T / 64), into which the kernel's pre-pass writes its tile map (for
    tests; scratch of its own otherwise)."""
    if q.device.type == "cpu":
        return rel_pos_attention_plain(q, k, v, p, bias_u, bias_v, mask,
                                       sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, k, v, p, bias_u, bias_v, mask)
    B, H, T, d = q.shape
    scale = 1.0 / math.sqrt(d) if sm_scale is None else float(sm_scale)
    q, k, v, p = (_unit_columns(t) for t in (q, k, v, p))
    if mask.dtype not in (torch.bool, torch.uint8):
        mask = mask != 0
    out = torch.empty_like(q)
    nt = -(-T // TILE)
    tile_map = tile_map_out
    if tile_map is None:
        tile_map = torch.empty(B, nt, nt, dtype=torch.uint8, device=q.device)
    elif (tile_map.shape != (B, nt, nt) or tile_map.dtype != torch.uint8
          or tile_map.device != q.device or not tile_map.is_contiguous()):
        raise ValueError(f"tile_map_out: want a contiguous ({B}, {nt}, {nt}) "
                         f"uint8 tensor on {q.device}")
    posb = torch.stack([bias_u.reshape(-1), bias_v.reshape(-1)])
    strides = (ctypes.c_longlong * 17)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        *p.stride()[:2], *mask.stride())
    from masr_tpu_torch.ops.cuda import build
    fn = build.load("rel_pos_attention").masr_rel_pos_attention
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(),
                 posb.data_ptr(), mask.data_ptr(), strides,
                 tile_map.data_ptr(), out.data_ptr(), B, H, T, d, scale,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rel_pos_attention kernel failed: CUDA error "
                           f"{err}")
    rel_pos_flash_attention.launches += 1
    return out


rel_pos_flash_attention.launches = 0
