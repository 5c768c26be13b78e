"""torch layers whose compute dtype is their input's: masr_tpu's flax layers
at `dtype=` (bf16 serving, masr_tpu/models/registry.py build_model).

The parameters stay f32. Linear and the convolutions cast them to the
input's dtype at the product (a copy kept per module, compute_weight), as
flax's nn.Dense and nn.Conv promote their kernel and bias to the compute
dtype, and round as flax does: the product (f32 sums) to the compute
dtype, then the bias added in it, a second rounding (another dtype than
f32, f64 in the finite-difference tests, the same way through torch's
product). A bf16 Linear, and a pointwise (kernel 1) Conv1d, in eval mode
take the serving kernels' own product
(ops/cuda/chunk_layer.py serving_product: the K split fixed by N and K),
so a row's bits do not depend on the rows beside it in the call: through
cuBLAS and cuDNN, whose algorithms follow the rows, a streaming window
alone and in the engine's batch parted by a bf16 rounding here and there
(with the attention's own products, models/attention.py `_half_mm`, they
flipped 10 of the 32 texts of the eager Efficient-Conformer's bf16 engine
on the H100). serving_product has no backward: in training mode (the
module's `training` flag, not grad mode: the server's handler threads
serve with grad mode on) a bf16 Linear or conv takes the differentiable
product of torch (F.linear / the conv on compute_weight's bf16 copy, f32
sums rounded once, as flax's Dense at bf16 under masr_tpu's enable_amp),
then its bias after that rounding. LayerNorm takes its statistics and its affine in f32 and
returns the input's dtype, as flax's nn.LayerNorm does at a half dtype;
BatchNorm1d in eval the same; their backward (autograd) keeps the f32
statistics. With an f32 input each is exactly its torch base class, so
the f32 routes keep their bits. The encoder casts its
features to the compute dtype after CMVN (masr_tpu/models/conformer.py
:242), and every layer downstream follows.
"""
import torch
from torch import nn
import torch.nn.functional as F


def _add_bias(y, bias, shape):
    """The flax order at a half dtype: y (already rounded) + bias, rounded
    again; bias broadcast along `shape`."""
    return y if bias is None else y + bias.to(y.dtype).view(shape)


def compute_weight(module, dtype, kn=False, name="weight"):
    """module.<name> (its weight by default) in dtype ((K, N) contiguous if
    kn: a Linear's or a pointwise conv's (N, K[, 1]) weight as a product's
    right operand), kept on the module while the parameter's storage and
    version stay (load_state_dict and optimizer steps write in place and
    bump the version), so a serving call does not cast it again. Not kept
    while autograd records through the parameter."""
    w = getattr(module, name)

    def layout(c):
        return c.reshape(c.shape[0], -1).t().contiguous() if kn else c

    if torch.is_grad_enabled() and w.requires_grad:
        return layout(w.to(dtype))
    key = (dtype, kn, w.device, w.data_ptr(), w._version)
    kept = module.__dict__.setdefault("_compute_weight", {})
    if name not in kept or kept[name][0] != key:
        kept[name] = (key, layout(w.detach().to(dtype)))
    return kept[name][1]


def half_product(x, module):
    """x (.., K) @ module's (N, K[, 1]) weight in bf16, through
    serving_product (f32 sums rounded once, bits independent of the
    rows)."""
    from masr_tpu_torch.ops.cuda.chunk_layer import serving_product
    return serving_product(x, compute_weight(module, x.dtype, kn=True))


def serves_bf16(x, module):
    """True where a bf16 product takes serving_product: a bf16 input to a
    module in eval mode (training mode needs the product's backward)."""
    return x.dtype == torch.bfloat16 and not module.training


class Linear(nn.Linear):
    def forward(self, x):
        if x.dtype == torch.float32:
            return super().forward(x)
        y = half_product(x, self) if serves_bf16(x, self) else \
            F.linear(x, compute_weight(self, x.dtype))
        return _add_bias(y, self.bias, (-1,))


class Conv1d(nn.Conv1d):
    def forward(self, x):
        if x.dtype == torch.float32:
            return super().forward(x)
        if serves_bf16(x, self) and self.kernel_size == (1,) and \
                self.groups == 1 and self.stride == (1,) and \
                self.padding == (0,):
            y = half_product(x.transpose(1, 2), self).transpose(1, 2)
        else:
            y = self._conv_forward(x, compute_weight(self, x.dtype), None)
        return _add_bias(y, self.bias, (-1, 1))


class Conv2d(nn.Conv2d):
    def forward(self, x):
        if x.dtype == torch.float32:
            return super().forward(x)
        return _add_bias(self._conv_forward(x, compute_weight(self, x.dtype),
                                            None), self.bias, (-1, 1, 1))


class BatchNorm1d(nn.BatchNorm1d):
    """Eval on a bf16 input as flax's nn.BatchNorm at that dtype
    (masr_tpu/models/convolution.py:57-63): (x - mean) · (rsqrt(var + eps)
    · scale) + bias over (B, C, T) in f32 from the running statistics, then
    rounded to bf16 once. Any other input, and training (the conv module's
    own batch statistics, f32 only), is torch's class."""

    def forward(self, x):
        if x.dtype != torch.bfloat16 or self.training:
            return super().forward(x)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - self.running_mean[:, None]) * mul[:, None] \
            + self.bias[:, None]
        return y.to(x.dtype)


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        if x.dtype == torch.float32:
            return super().forward(x)
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)
