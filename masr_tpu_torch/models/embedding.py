"""Positional encoding (port of masr_tpu/models/embedding.py:15-67).

Encodings are computed on the fly from absolute positions; the rel-pos
encoding is used without rel_shift, as the reference does. In training
mode both modules apply their dropout to x and to the returned encoding,
as masr_tpu does.
"""
import math

import torch
from torch import nn

from masr_tpu_torch.ops.common import dropout


def sinusoid_position_encoding(positions: torch.Tensor,
                               d_model: int) -> torch.Tensor:
    """positions (T,) → (T, d_model) f32: pe[:, 0::2] = sin,
    pe[:, 1::2] = cos (interleaved)."""
    half = d_model // 2
    div_term = torch.exp(
        torch.arange(0, d_model, 2, dtype=torch.float32,
                     device=positions.device)
        * -(math.log(10000.0) / d_model))
    args = positions.to(torch.float32)[:, None] * div_term[None, :]
    pe = torch.stack([torch.sin(args), torch.cos(args)],
                     dim=-1).reshape(-1, 2 * half)
    if 2 * half < d_model:           # odd d_model: trailing zero column
        pe = nn.functional.pad(pe, (0, d_model - 2 * half))
    return pe


class RelPositionalEncoding(nn.Module):
    """x · √d, and the encoding of absolute positions offset..offset+T-1
    returned separately as (1, T, d_model)."""

    def __init__(self, d_model: int, dropout_rate: float = 0.0):
        super().__init__()
        self.d_model = d_model
        self.dropout_rate = dropout_rate

    def pos_emb(self, offset, size, device=None):
        """(1, size, d_model): the sinusoid of max(offset + j, 0)
        (masr_tpu/models/embedding.py:55-57)."""
        positions = torch.clamp(offset + torch.arange(size, device=device),
                                min=0)
        return sinusoid_position_encoding(positions, self.d_model)[None]

    def forward(self, x, offset=0, generator=None):
        pos_emb = self.pos_emb(offset, x.shape[1], x.device).to(x.dtype)
        x = x * math.sqrt(self.d_model)
        return (dropout(x, self.dropout_rate, self.training, generator),
                dropout(pos_emb, self.dropout_rate, self.training, generator))


class PositionalEncoding(RelPositionalEncoding):
    """Absolute sinusoidal encoding: (x · √d + pe, pe), both through the
    dropout in training (the attention decoder's input)."""

    def forward(self, x, offset=0, generator=None):
        pos_emb = self.pos_emb(offset, x.shape[1], x.device).to(x.dtype)
        x = x * math.sqrt(self.d_model) + pos_emb
        return (dropout(x, self.dropout_rate, self.training, generator),
                dropout(pos_emb, self.dropout_rate, self.training, generator))
