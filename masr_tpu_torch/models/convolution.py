"""Conformer convolution module, full context and with the causal streaming
cache (port of masr_tpu/models/convolution.py:28-68).

pointwise(2C) + GLU → depthwise(k) → norm → activation → pointwise. The
norm is a LayerNorm (eps 1e-5) or a BatchNorm1d (eps 1e-5, momentum 0.1:
torch's convention for flax's 0.9), which in eval uses its running
statistics and in training updates them as flax does. Torch layout (B, C,
T) inside, as upstream MASR, so its weights apply. The causal cache holds
the last lorder = k-1 rows of the module's input BEFORE pointwise_conv1,
as masr_tpu's does.
"""
import torch
from torch import nn
import torch.nn.functional as F


class ConvolutionModule(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 15, activation=F.silu,
                 norm: str = "layer_norm", causal: bool = False):
        super().__init__()
        if norm not in ("layer_norm", "batch_norm"):
            raise ValueError(f"unknown conv module norm {norm!r}")
        if not causal and (kernel_size - 1) % 2:
            raise ValueError("non-causal conv needs an odd kernel size")
        self.lorder = kernel_size - 1 if causal else 0
        self.pointwise_conv1 = nn.Conv1d(channels, 2 * channels, 1)
        self.depthwise_conv = nn.Conv1d(
            channels, channels, kernel_size, groups=channels,
            padding=0 if causal else (kernel_size - 1) // 2)
        self.norm = nn.LayerNorm(channels, eps=1e-5) \
            if norm == "layer_norm" else \
            nn.BatchNorm1d(channels, eps=1e-5, momentum=0.1)
        self.pointwise_conv2 = nn.Conv1d(channels, channels, 1)
        self.activation = activation

    def forward(self, x, mask_pad=None, cache=None):
        """x: (B, T, C); mask_pad: (B, 1, T) bool non-pad mask or None;
        cache: None (causal: zero left pad) or (B, lorder, C) rows of a
        streaming cache → (out (B, T, C), new cache: the last lorder input
        rows, or None when not causal)."""
        if mask_pad is not None:
            x = x.masked_fill(~mask_pad.transpose(1, 2), 0.0)
        new_cache = None
        if self.lorder:
            # the pad / cache rows enter BEFORE pointwise_conv1, so zero
            # rows carry GLU(bias)
            if cache is None:
                x = F.pad(x, (0, 0, self.lorder, 0))
            else:
                x = torch.cat([cache, x], dim=1)
            new_cache = x[:, x.shape[1] - self.lorder:]
        x = F.glu(self.pointwise_conv1(x.transpose(1, 2)), dim=1)
        x = self.depthwise_conv(x)
        if isinstance(self.norm, nn.LayerNorm):
            x = self.norm(x.transpose(1, 2)).transpose(1, 2)
        elif self.training:
            x = self._batch_norm_train(x)
        else:
            x = self.norm(x)
        x = self.activation(x)
        x = self.pointwise_conv2(x).transpose(1, 2)
        if mask_pad is not None:
            x = x.masked_fill(~mask_pad.transpose(1, 2), 0.0)
        return x, new_cache

    def _batch_norm_train(self, x):
        """Train-mode BatchNorm as flax's (masr_tpu/models/convolution.py:
        61-62): normalise x (B, C, T) with the batch statistics over every
        (b, t), padded rows included, and move the running statistics by
        momentum 0.1 toward the batch mean and the BIASED batch variance
        (torch's BatchNorm1d would take the unbiased one)."""
        bn = self.norm
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2), unbiased=False)
            bn.running_mean.mul_(1.0 - bn.momentum).add_(bn.momentum * mean)
            bn.running_var.mul_(1.0 - bn.momentum).add_(bn.momentum * var)
            bn.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, bn.weight, bn.bias, training=True,
                            eps=bn.eps)
