"""Counter-based dropout masks, the plain PyTorch mirror of
`dropout_mult` in masr_tpu_torch/csrc/common.cuh.

The keep decision of element (row, col) of dropout site `site` of
utterance b in layer `layer` is a 32-bit integer hash of those and the
utterance's seed, so the training-layer kernel's forward, its backward and
the plain twin draw the same masks. masr_tpu draws its masks from the TPU's
own generator, which nothing else reproduces; the two packages agree in
distribution only.

The arithmetic is uint32 carried in int64 tensors: a 32-bit product is
taken in 16-bit limbs, so no int64 product overflows.
"""
import numpy as np
import torch

MASK32 = 0xFFFFFFFF
MIX_C1, MIX_C2 = 0x7FEB352D, 0x846CA68B


def _mul32(x, c):
    """(x * c) mod 2^32 for x in [0, 2^32) (int64 tensor), c a constant."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def mix32(x):
    """The "lowbias32" finaliser on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, MIX_C1)
    x = x ^ (x >> 15)
    x = _mul32(x, MIX_C2)
    return x ^ (x >> 16)


def dropout_params(rate):
    """→ (thresh, keep_scale): keep where hash >= thresh = rate · 2^32;
    kept elements scale by float32(1 / (1 - rate)). thresh 0 = no dropout."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} must be in [0, 1)")
    if rate == 0.0:
        return 0, 1.0
    thresh = min(int(rate * 2 ** 32), MASK32)
    return thresh, float(np.float32(1.0) / np.float32(1.0 - rate))


def dropout_hash(seeds, layer, site, rows, cols, row0=0):
    """seeds (B,) int; rows (R,), cols (C,) int tensors → (B, R, C) int64
    hashes in [0, 2^32); utterance b keyed as row0 + b (its row in the
    global batch)."""
    seeds = seeds.to(torch.int64) & MASK32
    b = torch.arange(seeds.shape[0], device=seeds.device,
                     dtype=torch.int64) + int(row0)
    word = (int(layer) << 20) | (int(site) << 16) | b
    h = mix32(seeds ^ mix32(word))
    h = mix32(h[:, None] ^ rows.to(torch.int64)[None, :])
    return mix32(h[:, :, None] ^ cols.to(torch.int64)[None, None, :])


def dropout_mask(seeds, layer, site, rows, cols, rate, row0=0):
    """(B, R, C) float32 inverted-dropout multipliers: keep_scale where
    kept, 0 where dropped (all 1 at rate 0)."""
    thresh, keep = dropout_params(rate)
    h = dropout_hash(seeds, layer, site, rows, cols, row0)
    return torch.where(h >= thresh, torch.tensor(keep, dtype=torch.float32,
                                                 device=h.device),
                       torch.tensor(0.0, dtype=torch.float32,
                                    device=h.device))


def layer_seeds(layers, B, generator, device):
    """The training-layer kernels' per-(layer, utterance) seeds (layers, B)
    int32 of this rank's B rows. They come from a generator of their own,
    seeded from the step generator's seed (its draws so far, whose sizes
    follow the rank's batch, leave them alone), for the global batch
    (layers, B x ranks), of which the rank takes the columns of its rows
    (parallel/mesh.py batch_shard): a row gets the same seeds, and so the
    same kernel dropout masks, whatever the number of ranks. generator
    None: the global generator's draw."""
    from masr_tpu_torch.parallel.mesh import batch_shard
    rank, world = batch_shard()
    g = generator
    if generator is not None:
        g = torch.Generator(device=generator.device)
        g.manual_seed((generator.initial_seed() * 0x9E3779B97F4A7C15 + 1)
                      % 2 ** 63)
    seeds = torch.randint(0, 2 ** 31 - 1, (layers, B * world), generator=g,
                          device=device, dtype=torch.int32)
    return seeds[:, rank * B:(rank + 1) * B] if world > 1 else seeds


def batch_row0(B):
    """The global batch row of this rank's first of B rows (0 in one
    process): the training kernels' `row0` hash key."""
    from masr_tpu_torch.parallel.mesh import batch_shard
    return batch_shard()[0] * B
