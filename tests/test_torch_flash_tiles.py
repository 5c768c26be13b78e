"""The flash attention's tile map (masr_tpu_torch/ops/cuda/
rel_pos_attention.py `mask_tile_map_plain`, the plain twin of the kernel's
pre-pass) on the CPU:

- the map (hidden / full / partial 64 x 64 tiles) against a numpy count
  over the masks the port builds: full context (the broadcast expand view),
  static chunk 16 with every left chunk and with 4, the half-rate
  [::2, ::2] view, and random masks with empty rows and tiles, at T' that
  are not multiples of 64;
- the twin with the hidden tiles dropped (each query tile attends to the
  keys of its visible tiles only, as the kernel walks them) equals the twin
  exactly, and still agrees with the Pallas kernel in interpret mode at
  tests/test_torch_flash_attention.py's tolerance (atol 2e-5).
The card's pre-pass is held against this map in
tests/test_torch_cuda_kernels.py. The full-context layers' key-length mask
(`length_tile_map_plain`, the tile kinds the kernel computes from the
lengths) is held against the map of the expanded length mask.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from masr_tpu.ops.pallas.attention import rel_pos_flash_attention as pallas
from masr_tpu_torch.ops.cuda import rel_pos_attention as rpa
from masr_tpu_torch.ops.masks import add_optional_chunk_mask, make_pad_mask

KINDS = ["full", "static16", "static16_left4", "half_rate", "random"]


def _mask(kind, T, lens):
    """(B, T, T) bool mask of one kind, built by the port's mask code."""
    if kind == "half_rate":
        return _mask("static16", 2 * T, [2 * n for n in lens])[:, ::2, ::2]
    if kind == "random":
        g = torch.Generator().manual_seed(T)
        m = torch.rand(len(lens), T, T, generator=g) < 0.3
        m[:, ::7] = False                   # empty rows
        m[:, :, 64:128] = False             # an empty key tile
        m[1] = False
        m[1, :, T // 2] = True              # one key
        m[2, :70] = True                    # full tiles
        return m
    pad = ~make_pad_mask(torch.tensor(lens), T)[:, None, :]
    chunk, left = {"full": (0, -1), "static16": (16, -1),
                   "static16_left4": (16, 4)}[kind]
    return add_optional_chunk_mask(T, pad, False, False, -1, chunk, left)


def _np_map(mask, tile=64):
    m = np.asarray(mask, dtype=bool)
    B, T, _ = m.shape
    nt = -(-T // tile)
    out = np.zeros((B, nt, nt), np.uint8)
    for b in range(B):
        for i in range(nt):
            for j in range(nt):
                blk = m[b, i * tile:(i + 1) * tile, j * tile:(j + 1) * tile]
                out[b, i, j] = 0 if not blk.any() else 1 if blk.all() else 2
    return out


@pytest.mark.parametrize("T", [37, 150, 299])
@pytest.mark.parametrize("kind", KINDS)
def test_tile_map_matches_numpy(kind, T):
    lens = [T, T - 17, max(T // 3, 1), 0]
    mask = _mask(kind, T, lens)
    if kind == "full":
        assert mask.stride(1) == 0                  # a broadcast view
    got = rpa.mask_tile_map_plain(mask)
    assert got.dtype == torch.uint8 and got.shape == (4, -(-T // 64),
                                                      -(-T // 64))
    np.testing.assert_array_equal(got.numpy(), _np_map(mask.numpy()))
    assert (got[3] == rpa.HIDDEN).all() == (kind != "random")
    kinds = set(got.unique().tolist())
    if T == 299 and kind in ("static16", "random"):
        assert kinds == {rpa.HIDDEN, rpa.FULL, rpa.PARTIAL}
    if kind == "static16_left4":                # 16 + 64 keys per row
        assert rpa.FULL not in kinds


def _inputs(B, H, T, d, seed):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.standard_normal((B, H, T, d)).astype(np.float32)
               for _ in range(3))
    p = rs.standard_normal((H, T, d)).astype(np.float32)
    bu, bv = ((0.1 * rs.standard_normal((H, d))).astype(np.float32)
              for _ in range(2))
    return q, k, v, p, bu, bv


def _hidden_tiles_dropped(q, k, v, p, bu, bv, mask, tile=64):
    """The twin where each 64-row query tile sees only the keys of the
    tiles its row of the map does not hide (their [k | p], v and mask
    columns gathered; 0 where it hides them all, as the kernel's rows that
    see no key); the hidden tiles' k, p and v are NaN first, so a read of
    one would show."""
    B, H, T, d = q.shape
    tmap = rpa.mask_tile_map_plain(mask, tile)
    out = torch.zeros_like(q)
    for b in range(B):
        for i in range(tmap.shape[1]):
            rows = slice(i * tile, min((i + 1) * tile, T))
            seen = (tmap[b, i] != rpa.HIDDEN).repeat_interleave(tile)[:T]
            if not seen.any():
                continue
            kb, vb, pb = (x.clone() for x in (k[b:b + 1], v[b:b + 1], p))
            for x in (kb, vb, pb):
                x[..., ~seen, :] = float("nan")
            out[b:b + 1, :, rows] = rpa.rel_pos_attention_plain(
                q[b:b + 1, :, rows], kb[:, :, seen], vb[:, :, seen],
                pb[:, seen], bu, bv, mask[b:b + 1, rows][:, :, seen])
    return out


@pytest.mark.parametrize("T,d", [(150, 16), (299, 64)])
@pytest.mark.parametrize("kind", KINDS)
def test_dropping_hidden_tiles_changes_nothing(kind, T, d):
    """Every row of every utterance, the one of length 0 too: the tiled
    twin is the twin bit for bit, and the Pallas kernel's within 2e-5."""
    lens = [T, T - 21, max(T // 3, 1), 0]
    mask = _mask(kind, T, lens)
    args = _inputs(4, 2, T, d, seed=T + d)
    targs = [torch.from_numpy(a) for a in args]
    twin = rpa.rel_pos_attention_plain(*targs, mask)
    tiled = _hidden_tiles_dropped(*targs, mask)
    assert torch.equal(tiled, twin)
    jargs = [jnp.asarray(a) for a in args] + [jnp.asarray(mask.numpy())]
    want = np.asarray(pallas(*jargs, interpret=True))
    np.testing.assert_allclose(tiled.numpy(), want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("T", [37, 150, 299])
def test_length_tile_map_matches_the_mask_map(T):
    """length_tile_map_plain(lens, T) == mask_tile_map_plain of the (B, T,
    T) mask in which every query row sees the keys col < len (the
    full-context layers' mask), lengths 0 and T' and around the 64-key
    tiles' edges."""
    lens = sorted({0, 1, T, T - 1, *(n for n in (63, 64, 65, 128, 129)
                                     if n < T)})
    lens_t = torch.tensor(lens)
    valid = torch.arange(T)[None, :] < lens_t[:, None]
    want = rpa.mask_tile_map_plain(valid[:, None, :].expand(len(lens), T, T))
    got = rpa.length_tile_map_plain(lens_t, T)
    assert got.dtype == torch.uint8
    assert torch.equal(got, want), (lens, got[:, 0], want[:, 0])
