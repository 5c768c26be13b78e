"""Transformer attention decoders for the hybrid loss (port of
masr_tpu/models/decoder.py: DecoderLayer :14, TransformerDecoder :61,
BiTransformerDecoder :127).

Module names follow upstream MASR (`decoder.left_decoder.decoders.{i}.
self_attn.linear_q`, `...embed.0.weight`, `...after_norm`,
`...output_layer`), which models/weights.py maps to and from masr_tpu's
flax tree. LayerNorms use eps 1e-12, as the reference's decoder does. The
products stay nn.Linear: masr_tpu runs them outside any Pallas kernel.
"""
import torch
from torch import nn

from masr_tpu_torch.models.attention import MultiHeadedAttention
from masr_tpu_torch.models.embedding import PositionalEncoding
from masr_tpu_torch.models.positionwise import PositionwiseFeedForward
from masr_tpu_torch.ops.common import dropout, get_activation
from masr_tpu_torch.ops.masks import make_pad_mask, subsequent_mask


def _layer_norm(size):
    return nn.LayerNorm(size, eps=1e-12)


class DecoderLayer(nn.Module):
    """Causal self-attention, cross-attention over the encoder rows, FFN
    (ReLU), each pre-norm with a residual."""

    def __init__(self, size, attention_heads, linear_units, dropout_rate=0.1,
                 self_attention_dropout_rate=0.0,
                 src_attention_dropout_rate=0.0, normalize_before=True):
        super().__init__()
        if not normalize_before:
            raise NotImplementedError("normalize_before=False decoder "
                                      "layers are not ported")
        self.self_attn = MultiHeadedAttention(attention_heads, size,
                                              self_attention_dropout_rate)
        self.src_attn = MultiHeadedAttention(attention_heads, size,
                                             src_attention_dropout_rate)
        self.feed_forward = PositionwiseFeedForward(
            size, linear_units, get_activation("relu"), dropout_rate)
        self.norm1 = _layer_norm(size)
        self.norm2 = _layer_norm(size)
        self.norm3 = _layer_norm(size)
        self.dropout_rate = dropout_rate

    def _drop(self, x, generator):
        return dropout(x, self.dropout_rate, self.training, generator)

    def forward(self, tgt, tgt_mask, memory, memory_mask, generator=None):
        x = self.norm1(tgt)
        x = tgt + self._drop(self.self_attn(x, x, x, tgt_mask, generator),
                             generator)
        y = self.norm2(x)
        x = x + self._drop(self.src_attn(y, memory, memory, memory_mask,
                                         generator), generator)
        return x + self._drop(self.feed_forward(self.norm3(x), generator),
                              generator)


class TransformerDecoder(nn.Module):
    """Embedding + absolute positions → layers → LayerNorm → vocabulary
    projection."""

    def __init__(self, vocab_size, encoder_output_size, attention_heads=4,
                 linear_units=2048, num_blocks=6, dropout_rate=0.1,
                 positional_dropout_rate=0.1,
                 self_attention_dropout_rate=0.0,
                 src_attention_dropout_rate=0.0, use_output_layer=True,
                 normalize_before=True):
        super().__init__()
        if not use_output_layer:
            raise NotImplementedError("use_output_layer=False is not ported")
        D = encoder_output_size
        self.embed = nn.Sequential(
            nn.Embedding(vocab_size, D),
            PositionalEncoding(D, positional_dropout_rate))
        self.decoders = nn.ModuleList(
            DecoderLayer(D, attention_heads, linear_units, dropout_rate,
                         self_attention_dropout_rate,
                         src_attention_dropout_rate, normalize_before)
            for _ in range(num_blocks))
        self.after_norm = _layer_norm(D)
        self.output_layer = nn.Linear(D, vocab_size)

    def forward(self, memory, memory_mask, ys_in_pad, ys_in_lens,
                generator=None):
        """memory (B, T, D), memory_mask (B, 1, T), ys_in_pad (B, L) →
        (B, L, V) logits."""
        L = ys_in_pad.shape[1]
        tgt_mask = ~make_pad_mask(ys_in_lens, L)[:, None, :] & \
            subsequent_mask(L, ys_in_pad.device)[None]
        x, _ = self.embed[1](self.embed[0](ys_in_pad), 0, generator)
        for layer in self.decoders:
            x = layer(x, tgt_mask, memory, memory_mask, generator)
        return self.output_layer(self.after_norm(x))


class BiTransformerDecoder(nn.Module):
    """Left-to-right decoder and, with r_num_blocks > 0, a right-to-left
    one."""

    def __init__(self, vocab_size, encoder_output_size, attention_heads=4,
                 linear_units=2048, num_blocks=6, r_num_blocks=0,
                 dropout_rate=0.1, positional_dropout_rate=0.1,
                 self_attention_dropout_rate=0.0,
                 src_attention_dropout_rate=0.0, use_output_layer=True,
                 normalize_before=True):
        super().__init__()
        common = dict(vocab_size=vocab_size,
                      encoder_output_size=encoder_output_size,
                      attention_heads=attention_heads,
                      linear_units=linear_units, dropout_rate=dropout_rate,
                      positional_dropout_rate=positional_dropout_rate,
                      self_attention_dropout_rate=self_attention_dropout_rate,
                      src_attention_dropout_rate=src_attention_dropout_rate,
                      use_output_layer=use_output_layer,
                      normalize_before=normalize_before)
        self.r_num_blocks = r_num_blocks
        self.left_decoder = TransformerDecoder(num_blocks=num_blocks,
                                               **common)
        if r_num_blocks > 0:
            self.right_decoder = TransformerDecoder(num_blocks=r_num_blocks,
                                                    **common)

    def forward(self, memory, memory_mask, ys_in_pad, ys_in_lens,
                r_ys_in_pad=None, reverse_weight=0.0, generator=None):
        """→ (left logits (B, L, V), right logits or None)."""
        l_x = self.left_decoder(memory, memory_mask, ys_in_pad, ys_in_lens,
                                generator)
        r_x = None
        if reverse_weight > 0.0 and self.r_num_blocks > 0:
            r_x = self.right_decoder(memory, memory_mask, r_ys_in_pad,
                                     ys_in_lens, generator)
        return l_x, r_x
