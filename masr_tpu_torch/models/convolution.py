"""Conformer convolution module, full context and with the causal streaming
cache (port of masr_tpu/models/convolution.py:28-68).

pointwise(2C) + GLU → depthwise(k) → norm → activation → pointwise. The
norm is a LayerNorm (eps 1e-5) or a BatchNorm1d (eps 1e-5, momentum 0.1:
torch's convention for flax's 0.9), which in eval uses its running
statistics and in training updates them as flax does. Torch layout (B, C,
T) inside, as upstream MASR, so its weights apply. The BatchNorm follows
its input's dtype, as flax's at dtype=bf16: in eval through
models/layers.py BatchNorm1d, in training through _batch_norm_train (f32
statistics, bf16 output). The causal cache holds
the last lorder = k-1 rows of the module's input BEFORE pointwise_conv1,
as masr_tpu's does. With stride s > 1 (the Efficient-Conformer's stride
layers, masr_tpu/models/efficient_conformer.py:108-160) the depthwise conv
strides time: T rows give ceil(T / s), masked by the pad mask's every s-th
column. The compute dtype is the input's (models/layers.py); a cache is
read in it, as masr_tpu's casts its cache to x's dtype.
"""
import torch
from torch import nn
import torch.nn.functional as F

from masr_tpu_torch.models.layers import BatchNorm1d, Conv1d, LayerNorm
from masr_tpu_torch.parallel.mesh import active, all_reduce_sum
from masr_tpu_torch.ops.common import glu


class ConvolutionModule(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 15, activation=F.silu,
                 norm: str = "layer_norm", causal: bool = False,
                 stride: int = 1):
        super().__init__()
        if norm not in ("layer_norm", "batch_norm"):
            raise ValueError(f"unknown conv module norm {norm!r}")
        if not causal and (kernel_size - 1) % 2:
            raise ValueError("non-causal conv needs an odd kernel size")
        self.lorder = kernel_size - 1 if causal else 0
        self.pointwise_conv1 = Conv1d(channels, 2 * channels, 1)
        self.depthwise_conv = Conv1d(
            channels, channels, kernel_size, stride=stride, groups=channels,
            padding=0 if causal else (kernel_size - 1) // 2)
        self.stride = stride
        self.norm = LayerNorm(channels, eps=1e-5) \
            if norm == "layer_norm" else \
            BatchNorm1d(channels, eps=1e-5, momentum=0.1)
        self.pointwise_conv2 = Conv1d(channels, channels, 1)
        self.activation = activation

    def forward(self, x, mask_pad=None, cache=None):
        """x: (B, T, C); mask_pad: (B, 1, T) bool non-pad mask or None;
        cache: None (causal: zero left pad) or (B, lorder, C) rows of a
        streaming cache → (out (B, ceil(T / stride), C), new cache: the
        last lorder input rows, or None when not causal)."""
        if mask_pad is not None:
            x = x.masked_fill(~mask_pad.transpose(1, 2), 0.0)
        new_cache = None
        if self.lorder:
            # the pad / cache rows enter BEFORE pointwise_conv1, so zero
            # rows carry GLU(bias)
            if cache is None:
                x = F.pad(x, (0, 0, self.lorder, 0))
            else:
                x = torch.cat([cache.to(x.dtype), x], dim=1)
            new_cache = x[:, x.shape[1] - self.lorder:]
        x = glu(self.pointwise_conv1(x.transpose(1, 2)), dim=1)
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
            x = x.masked_fill(~mask_pad[:, :, ::self.stride].transpose(1, 2),
                              0.0)
        return x, new_cache

    def _batch_norm_train(self, x):
        """Train-mode BatchNorm as flax's (masr_tpu/models/convolution.py:
        61-62): normalise x (B, C, T) with the batch statistics over every
        (b, t), padded rows included, and move the running statistics by
        momentum 0.1 toward the batch mean and the BIASED batch variance
        (torch's BatchNorm1d would take the unbiased one). A bf16 x takes
        flax's nn.BatchNorm at dtype=bf16 (flax/linen/normalization.py
        _compute_stats, _normalize): x widened to f32, mean E[x] and
        variance max(E[x²] - E[x]², 0) in f32, (x - mean) · (rsqrt(var +
        eps) · scale) + bias in f32, rounded to bf16 once; the running
        statistics stay f32 and autograd carries the grads through the
        statistics, as jax.grad does.

        Over several ranks (parallel/mesh.py active grid) the statistics
        span the global batch, as flax's do over masr_tpu's sharded batch:
        the sums of x and x² and the count are summed over the ranks
        (differentiably) before the same arithmetic, and the running
        statistics move toward the global values. An f32 x in one process
        takes var_mean and F.batch_norm."""
        bn = self.norm
        grid = active()
        if x.dtype == torch.float32 and grid is None:
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=(0, 2), unbiased=False)
                self._move_running(mean, var)
            return F.batch_norm(x, None, None, bn.weight, bn.bias,
                                training=True, eps=bn.eps)
        xf = x.float()
        C = xf.shape[1]
        n = torch.full((1,), float(xf.shape[0] * xf.shape[2]),
                       device=xf.device)
        sums = torch.cat([xf.sum(dim=(0, 2)), (xf * xf).sum(dim=(0, 2)), n])
        if grid is not None:
            sums = all_reduce_sum(sums)
        mean = sums[:C] / sums[-1]
        var = torch.clamp(sums[C:2 * C] / sums[-1] - mean * mean, min=0.0)
        with torch.no_grad():
            self._move_running(mean, var)
        mul = torch.rsqrt(var + bn.eps) * bn.weight
        y = (xf - mean[:, None]) * mul[:, None] + bn.bias[:, None]
        return y.to(x.dtype)

    def _move_running(self, mean, var):
        bn = self.norm
        bn.running_mean.mul_(1.0 - bn.momentum).add_(bn.momentum * mean)
        bn.running_var.mul_(1.0 - bn.momentum).add_(bn.momentum * var)
        bn.num_batches_tracked.add_(1)
