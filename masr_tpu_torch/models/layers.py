"""torch layers whose compute dtype is their input's: masr_tpu's flax layers
at `dtype=` (bf16 serving, masr_tpu/models/registry.py build_model).

The parameters stay f32. Linear and the convolutions cast them to the
input's dtype at the product (a copy kept per module, compute_weight), as
flax's nn.Dense and nn.Conv promote their kernel and bias to the compute
dtype, and round as flax does: the product (f32 sums) to the compute
dtype, then the bias added in it, a second rounding. LayerNorm takes its statistics and its affine in f32 and returns
the input's dtype, as flax's nn.LayerNorm does at a half dtype. With an
f32 input each is exactly its torch base class, so the f32 routes keep
their bits. The encoder casts its features to the compute dtype after CMVN
(masr_tpu/models/conformer.py:242), and every layer downstream follows.
"""
import torch
from torch import nn
import torch.nn.functional as F


def _add_bias(y, bias, shape):
    """The flax order at a half dtype: y (already rounded) + bias, rounded
    again; bias broadcast along `shape`."""
    return y if bias is None else y + bias.to(y.dtype).view(shape)


def compute_weight(module, dtype, kn=False):
    """module.weight in dtype ((K, N) contiguous if kn: a Linear's weight
    as a product's right operand), kept on the module while the weight's
    storage and version stay (load_state_dict and optimizer steps write in
    place and bump the version), so a serving call does not cast it again.
    Not kept while autograd records through the weight."""
    w = module.weight
    if torch.is_grad_enabled() and w.requires_grad:
        w = w.to(dtype)
        return w.t().contiguous() if kn else w
    key = (dtype, kn, w.device, w.data_ptr(), w._version)
    kept = module.__dict__.get("_compute_weight")
    if kept is None or kept[0] != key:
        c = w.detach().to(dtype)
        kept = (key, c.t().contiguous() if kn else c)
        module.__dict__["_compute_weight"] = kept
    return kept[1]


class Linear(nn.Linear):
    def forward(self, x):
        if x.dtype == torch.float32:
            return super().forward(x)
        return _add_bias(F.linear(x, compute_weight(self, x.dtype)),
                         self.bias, (-1,))


class BatchInvariantLinear(Linear):
    """Linear whose bf16 product is the serving kernels' own
    (ops/cuda/chunk_layer.py serving_product: the K split fixed by N and K),
    so a row's bits do not depend on the rows beside it in the call; f32 as
    Linear. The Conformer's subsampling output product (K = 4864) runs
    here: through cuBLAS a window alone and in the engine's batch parted by
    a bf16 rounding in ~1e-4 of its outputs."""

    def forward(self, x):
        if x.dtype == torch.float32:
            return super().forward(x)
        from masr_tpu_torch.ops.cuda.chunk_layer import serving_product
        return _add_bias(serving_product(x, compute_weight(self, x.dtype,
                                                           kn=True)),
                         self.bias, (-1,))


class Conv1d(nn.Conv1d):
    def forward(self, x):
        if x.dtype == torch.float32:
            return super().forward(x)
        return _add_bias(self._conv_forward(x, compute_weight(self, x.dtype),
                                            None), self.bias, (-1, 1))


class Conv2d(nn.Conv2d):
    def forward(self, x):
        if x.dtype == torch.float32:
            return super().forward(x)
        return _add_bias(self._conv_forward(x, compute_weight(self, x.dtype),
                                            None), self.bias, (-1, 1, 1))


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        if x.dtype == torch.float32:
            return super().forward(x)
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)
