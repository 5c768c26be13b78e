"""Input subsampling (port of masr_tpu/models/subsampling.py:44-73 and
:140-176, with the mask-free streaming call).

Ported: Conv2dSubsampling4 ("conv2d"), the Conformer flagship's, the
Squeezeformer's DepthwiseConv2dSubsampling4, Conv2dSubsampling2
("conv2d2", masr_tpu/models/subsampling.py:180-208), which only the
Efficient-Conformer offers, and DeepSpeech2's Conv2dSubsampling4Pure
(:210-237). All compute in torch's NCHW with upstream
MASR's channel-major flatten, so upstream weights apply directly (the
weight map permutes the flax linear). Each computes in its input's dtype
(models/layers.py), as masr_tpu's at its dtype: in bf16 every conv rounds
its f32 sums once and adds its bias in bf16, and the output product (K =
odim·F', 19 or 39 odim at 80 features) is the serving kernels' (a bf16
Linear), so a streaming window's bits do not depend on how many windows
share the call.
"""
import torch
from torch import nn

from masr_tpu_torch.models.embedding import RelPositionalEncoding
from masr_tpu_torch.models.layers import Conv2d, Linear
from masr_tpu_torch.ops.common import dropout


class Conv2dSubsampling4(nn.Module):
    """Two (3x3, stride 2) convs + linear: rate 4, right context 6; in the
    input's dtype (models/layers.py), as masr_tpu's at its dtype."""

    def __init__(self, idim: int, odim: int, pos_dropout_rate: float = 0.0):
        super().__init__()
        self.conv = nn.Sequential(Conv2d(1, odim, 3, 2), nn.ReLU(),
                                  Conv2d(odim, odim, 3, 2), nn.ReLU())
        freq = ((idim - 1) // 2 - 1) // 2
        self.out = nn.Sequential(Linear(odim * freq, odim))
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


class Conv2dSubsampling2(nn.Module):
    """One (3x3, stride 2) conv + linear: rate 2, right context 2."""

    def __init__(self, idim: int, odim: int, pos_dropout_rate: float = 0.0):
        super().__init__()
        self.conv = nn.Sequential(Conv2d(1, odim, 3, 2), nn.ReLU())
        self.out = nn.Sequential(Linear(odim * ((idim - 1) // 2), odim))
        self.pos_enc = RelPositionalEncoding(odim, pos_dropout_rate)

    def forward(self, x, x_mask=None, offset=0, generator=None):
        """As Conv2dSubsampling4.forward, at rate 2."""
        x = self.conv(x[:, None])                       # (B, C, T', F')
        B, C, T, F = x.shape
        x = self.out(x.transpose(1, 2).reshape(B, T, C * F))
        x, pos_emb = self.pos_enc(x, offset, generator)
        if x_mask is not None:
            x_mask = x_mask[:, :, :-2:2]
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
        self.pw_conv = Conv2d(1, odim, 3, 2)
        self.dw_conv = Conv2d(odim, odim, 3, 2,
                              groups=odim if dw_stride else 1)
        freq = ((idim - 1) // 2 - 1) // 2
        self.pos_enc = RelPositionalEncoding(odim, 0.1)
        self.input_proj = nn.Sequential(Linear(odim * freq, odim))
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


class Conv2dSubsampling4Pure(nn.Module):
    """DeepSpeech2's conv entry: two (3x3, stride 2) VALID convs with ReLU,
    no linear and no positional encoding; the output is the flattened conv
    features (B, T', odim·F'), channel-major as upstream's. It has no
    output product; its convs are the Conformer's kind (cuDNN on the
    card)."""

    def __init__(self, idim: int, odim: int = 32):
        super().__init__()
        self.conv = nn.Sequential(Conv2d(1, odim, 3, 2), nn.ReLU(),
                                  Conv2d(odim, odim, 3, 2), nn.ReLU())
        self.output_dim = odim * (((idim - 1) // 2 - 1) // 2)

    def forward(self, x, x_len=None):
        """x (B, T, F), x_len (B,) or None → (B, T', odim·F'), lengths
        ((len - 3) // 2 + 1 twice, masr_tpu's formula) or None."""
        x = self.conv(x[:, None])                       # (B, C, T', F')
        B, C, T, F = x.shape
        x = x.transpose(1, 2).reshape(B, T, C * F)
        if x_len is not None:
            x_len = torch.div(x_len - 3, 2, rounding_mode="floor") + 1
            x_len = torch.div(x_len - 3, 2, rounding_mode="floor") + 1
        return x, x_len


def subsampling_class(input_layer: str, family: str = "conformer"):
    """The subsampling of `input_layer` for a model family: conv2d for
    every family of the attention encoders, conv2d2 for the
    Efficient-Conformer alone (its table in
    masr_tpu/models/efficient_conformer.py:365-366); DeepSpeech2's conv2d
    is the pure conv entry (masr_tpu/models/deepspeech2.py:159)."""
    table = {"conv2d": Conv2dSubsampling4Pure if family == "deepspeech2"
             else Conv2dSubsampling4}
    if family == "efficient_conformer":
        table["conv2d2"] = Conv2dSubsampling2
    if input_layer not in table:
        raise NotImplementedError(
            f"input_layer {input_layer!r} is not ported yet for the "
            f"{family} (ported: {', '.join(sorted(table))})")
    return table[input_layer]
