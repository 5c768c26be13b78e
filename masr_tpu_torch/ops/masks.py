"""Padding and attention masks (port of masr_tpu/ops/masks.py:14-96).

Mask convention: True = attend / valid, as the reference. The dynamic
chunk of training is drawn on the host from a torch.Generator on the CPU,
so the CPU and the card draw the same chunk from the same seed; the mask is
then built on the device from index comparisons.
"""
import torch


def make_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) lengths → (B, T) bool, True at padded positions."""
    return (torch.arange(max_len, device=lengths.device)[None, :]
            >= lengths[:, None])


def subsequent_mask(size: int, device=None) -> torch.Tensor:
    """(T, T) lower-triangular causal mask, True = visible."""
    return torch.ones(size, size, dtype=torch.bool, device=device).tril()


def subsequent_chunk_mask(size: int, chunk_size: int, num_left_chunks=-1,
                          device=None) -> torch.Tensor:
    """(T, T) block-causal chunk mask: row i sees columns j with
    j < (i // chunk + 1) · chunk, and, when num_left_chunks >= 0,
    j >= max(0, (i // chunk - num_left_chunks) · chunk)."""
    idx = torch.arange(size, device=device)
    row_chunk = idx[:, None] // chunk_size
    ok = idx[None, :] < (row_chunk + 1) * chunk_size
    if num_left_chunks >= 0:
        ok &= idx[None, :] >= torch.clamp(
            (row_chunk - num_left_chunks) * chunk_size, min=0)
    return ok


def draw_dynamic_chunk(xs_len: int, use_dynamic_left_chunk: bool,
                       generator=None):
    """The reference's dynamic-chunk draw (masr_tpu/ops/masks.py:72-87) →
    (chunk_size, num_left_chunks) as ints: chunk = randint[1, T); over
    T // 2 means full context, else chunk % 25 + 1; with dynamic left
    chunks, num_left = randint[0, max((T - 1) // chunk, 1)) (upstream
    mask.py:130, high-exclusive). generator: a CPU torch.Generator."""
    draw = int(torch.randint(1, max(xs_len, 2), (), generator=generator))
    full = draw > xs_len // 2
    chunk = xs_len if full else draw % 25 + 1
    num_left = -1
    if use_dynamic_left_chunk:
        max_left = (xs_len - 1) // chunk
        left = int(torch.randint(0, max(max_left, 1), (),
                                 generator=generator))
        num_left = -1 if full else left
    return chunk, num_left


def add_optional_chunk_mask(xs_len: int, masks: torch.Tensor,
                            use_dynamic_chunk: bool,
                            use_dynamic_left_chunk: bool,
                            decoding_chunk_size: int, static_chunk_size: int,
                            num_decoding_left_chunks: int, generator=None):
    """Pad mask (B, 1, T) & a chunk mask → (B, T, T) bool. With a dynamic
    chunk and decoding_chunk_size 0 (training) the chunk is drawn from
    `generator`; < 0 is full context; > 0 a fixed chunk."""
    dev = masks.device
    if use_dynamic_chunk:
        if decoding_chunk_size < 0:
            chunk, num_left = xs_len, -1
        elif decoding_chunk_size > 0:
            chunk, num_left = decoding_chunk_size, num_decoding_left_chunks
        else:
            chunk, num_left = draw_dynamic_chunk(
                xs_len, use_dynamic_left_chunk, generator)
        chunk_masks = subsequent_chunk_mask(xs_len, chunk, num_left, dev)
    elif static_chunk_size > 0:
        chunk_masks = subsequent_chunk_mask(xs_len, static_chunk_size,
                                            num_decoding_left_chunks, dev)
    else:
        return masks.expand(masks.shape[0], xs_len, xs_len)
    return masks & chunk_masks[None]
