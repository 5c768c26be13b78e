"""Input subsampling (port of masr_tpu/models/subsampling.py:44-73, with
the mask-free streaming call).

Only Conv2dSubsampling4 ("conv2d"), the flagship's, is ported. It computes
in torch's NCHW with upstream MASR's channel-major flatten, so upstream
weights apply directly (the weight map permutes the flax linear).
"""
from torch import nn

from masr_tpu_torch.models.embedding import RelPositionalEncoding


class Conv2dSubsampling4(nn.Module):
    """Two (3x3, stride 2) convs + linear: rate 4, right context 6."""

    def __init__(self, idim: int, odim: int):
        super().__init__()
        self.conv = nn.Sequential(nn.Conv2d(1, odim, 3, 2), nn.ReLU(),
                                  nn.Conv2d(odim, odim, 3, 2), nn.ReLU())
        freq = ((idim - 1) // 2 - 1) // 2
        self.out = nn.Sequential(nn.Linear(odim * freq, odim))
        self.pos_enc = RelPositionalEncoding(odim)

    def forward(self, x, x_mask=None, offset=0):
        """x: (B, T, F); x_mask: (B, 1, T) or None (a streaming chunk) →
        (B, T', odim), pos_emb (1, T', odim) of positions offset.., mask
        (B, 1, T') or None."""
        x = self.conv(x[:, None])                       # (B, C, T', F')
        B, C, T, F = x.shape
        x = self.out(x.transpose(1, 2).reshape(B, T, C * F))
        x, pos_emb = self.pos_enc(x, offset)
        if x_mask is not None:
            x_mask = x_mask[:, :, :-2:2][:, :, :-2:2]
        return x, pos_emb, x_mask


def subsampling_class(input_layer: str):
    if input_layer != "conv2d":
        raise NotImplementedError(
            f"input_layer {input_layer!r} is not ported yet (this slice "
            "ports conv2d, Conv2dSubsampling4)")
    return Conv2dSubsampling4
