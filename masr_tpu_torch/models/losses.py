"""CTC head and label-smoothing loss (port of masr_tpu/models/losses.py:
CTCHead :11-52, label_smoothing_loss :55-79).

The CTC loss goes through the CTC kernel (ops/cuda/ctc_loss.py) on the
card and its plain twin on the CPU. The projection stays a linear layer
in the encoder's dtype (models/layers.py), as masr_tpu leaves it to XLA;
the softmax is f32.
"""
import torch
from torch import nn

from masr_tpu_torch.models.layers import Linear
from masr_tpu_torch.ops.common import IGNORE_ID
from masr_tpu_torch.ops.cuda.ctc_loss import ctc_loss


class CTCHead(nn.Module):
    """Linear projection + the CTC loss (masr_tpu's head also carries a
    dropout that no config sets; it is left out)."""

    def __init__(self, idim: int, odim: int):
        super().__init__()
        self.ctc_lo = Linear(idim, odim)

    def forward(self, hs_pad, hlens, ys_pad, ys_lens):
        """The reference's reduction: per-utterance CTC NLL of (B, T, D)
        encoder rows hs_pad with hlens valid frames, labels ys_pad (-1
        padded) of ys_lens, averaged over the batch → scalar."""
        logits = self.ctc_lo(hs_pad).float()
        labels = torch.where(ys_pad == IGNORE_ID, torch.zeros_like(ys_pad),
                             ys_pad)
        return ctc_loss(logits, hlens, labels, ys_lens, blank=0).mean()

    def logits(self, hs_pad):
        return self.ctc_lo(hs_pad)

    def softmax(self, hs_pad):
        return torch.softmax(self.ctc_lo(hs_pad).float(), dim=2)


def label_smoothing_loss(logits, target, size, padding_idx=IGNORE_ID,
                         smoothing=0.1, normalize_length=False):
    """KL(smoothed one-hot ‖ softmax(logits)) summed over non-padding
    positions, divided by the batch (or by the token count when
    normalize_length). logits (B, L, V); target (B, L)."""
    B = logits.shape[0]
    x = logits.reshape(-1, size).float()
    t = target.reshape(-1)
    ignore = t == padding_idx
    t_safe = torch.where(ignore, torch.zeros_like(t), t)
    confidence, low = 1.0 - smoothing, smoothing / (size - 1)
    true_dist = torch.full_like(x, low).scatter(
        1, t_safe[:, None], confidence)
    log_probs = torch.log_softmax(x, dim=1)
    safe_log_true = torch.where(true_dist > 0, torch.log(true_dist),
                                torch.zeros_like(true_dist))
    kl = torch.where(ignore[:, None], torch.zeros_like(x),
                     true_dist * (safe_log_true - log_probs))
    denom = torch.clamp((~ignore).sum(), min=1) if normalize_length else B
    return kl.sum() / denom
