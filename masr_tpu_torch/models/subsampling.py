"""Input subsampling (port of masr_tpu/models/subsampling.py:44-73 and
:140-176, with the mask-free streaming call).

Ported: Conv2dSubsampling4 ("conv2d"), the Conformer flagship's, and the
Squeezeformer's DepthwiseConv2dSubsampling4. Both compute in torch's NCHW
with upstream MASR's channel-major flatten, so upstream weights apply
directly (the weight map permutes the flax linear).
"""
import torch
from torch import nn

from masr_tpu_torch.models.embedding import RelPositionalEncoding
from masr_tpu_torch.ops.common import dropout


class Conv2dSubsampling4(nn.Module):
    """Two (3x3, stride 2) convs + linear: rate 4, right context 6."""

    def __init__(self, idim: int, odim: int, pos_dropout_rate: float = 0.0):
        super().__init__()
        self.conv = nn.Sequential(nn.Conv2d(1, odim, 3, 2), nn.ReLU(),
                                  nn.Conv2d(odim, odim, 3, 2), nn.ReLU())
        freq = ((idim - 1) // 2 - 1) // 2
        self.out = nn.Sequential(nn.Linear(odim * freq, odim))
        self.pos_enc = RelPositionalEncoding(odim, pos_dropout_rate)

    def forward(self, x, x_mask=None, offset=0, generator=None):
        """x: (B, T, F); x_mask: (B, 1, T) or None (a streaming chunk) →
        (B, T', odim), pos_emb (1, T', odim) of positions offset.., mask
        (B, 1, T') or None. In training mode the positional dropout draws
        from `generator`."""
        x = self.conv(x[:, None])                       # (B, C, T', F')
        B, C, T, F = x.shape
        x = self.out(x.transpose(1, 2).reshape(B, T, C * F))
        x, pos_emb = self.pos_enc(x, offset, generator)
        if x_mask is not None:
            x_mask = x_mask[:, :, :-2:2][:, :, :-2:2]
        return x, pos_emb, x_mask


class DepthwiseConv2dSubsampling4(nn.Module):
    """Squeezeformer subsampling: a (3x3, stride 2) "pointwise" conv, ReLU,
    a (3x3, stride 2) "depthwise" conv (grouped only with dw_stride; the
    encoder passes False), ReLU, the rel-pos encoding, then input_proj:
    rate 4, right context 6. In training, as masr_tpu's
    (masr_tpu/models/subsampling.py:140-176): the encoding's dropout at
    0.1 (masr_tpu's encoder leaves its pos_dropout_rate at that default,
    whatever the config), and after input_proj a dropout at dropout_rate
    (the encoder's input_dropout_rate)."""

    def __init__(self, idim: int, odim: int, dropout_rate: float = 0.0,
                 dw_stride: bool = False):
        super().__init__()
        self.pw_conv = nn.Conv2d(1, odim, 3, 2)
        self.dw_conv = nn.Conv2d(odim, odim, 3, 2,
                                 groups=odim if dw_stride else 1)
        freq = ((idim - 1) // 2 - 1) // 2
        self.pos_enc = RelPositionalEncoding(odim, 0.1)
        self.input_proj = nn.Sequential(nn.Linear(odim * freq, odim))
        self.dropout_rate = dropout_rate

    def forward(self, x, x_mask=None, offset=0, generator=None):
        """As Conv2dSubsampling4.forward; the encoding scales the flattened
        conv features before input_proj (masr_tpu's order)."""
        x = torch.relu(self.pw_conv(x[:, None]))
        x = torch.relu(self.dw_conv(x))                 # (B, C, T', F')
        B, C, T, F = x.shape
        x, pos_emb = self.pos_enc(x.transpose(1, 2).reshape(B, T, C * F),
                                  offset, generator)
        x = dropout(self.input_proj(x), self.dropout_rate, self.training,
                    generator)
        if x_mask is not None:
            x_mask = x_mask[:, :, :-2:2][:, :, :-2:2]
        return x, pos_emb, x_mask


def subsampling_class(input_layer: str):
    if input_layer != "conv2d":
        raise NotImplementedError(
            f"input_layer {input_layer!r} is not ported yet (this slice "
            "ports conv2d, Conv2dSubsampling4)")
    return Conv2dSubsampling4
