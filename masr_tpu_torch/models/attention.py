"""Multi-head attention: the plain one (self and cross attention, the
attention decoder's) and rel-pos self-attention, full context and with a
streaming cache (port of masr_tpu/models/attention.py:21-28, :31-88,
:91-151 and cache_key_mask :173-178). In training mode the attention
probabilities go through dropout, drawn from the `generator` argument.

The streaming cache of this eager module is masr_tpu's: a right-aligned
fixed (B, h, C, 2·d_k) array of [K ‖ V] rows, newest last, with a count of
valid rows. It is the reference the chunk-layer kernel's ring layout is
held against (models/weights.py converts between the two).

The flash route (masr_tpu's `_flash`, masr_tpu/models/attention.py:125-130,
:153-165): a rel-pos call takes the masked attention kernel,
`rel_pos_flash_attention` (ops/cuda/rel_pos_attention.py; its plain twin on
CPU tensors), when `RelPositionMultiHeadedAttention.flash_route` holds:
  - it has no cache, and its mask is a square (B, T, T) one;
  - no attention dropout acts (training mode with a rate > 0 keeps the
    eager code, as masr_tpu's route refuses dropout);
  - autograd does not record it (grad disabled, or neither the input nor a
    parameter requires grad): the kernel has no backward, as the Pallas
    kernel has none.
Every other call runs the eager code below. There is no length crossover:
on a CUDA tensor every eligible call launches the kernel.

The compute dtype is the input's (models/layers.py): at bf16, as
masr_tpu's modules at dtype=bf16, the projections are bf16, the scores are
f32 sums of bf16 products and the softmax is f32, the probabilities are
rounded to bf16 before P.V (f32 sums, rounded to bf16), the position
biases are cast to bf16 before they are added to q, and a cache is read
in the input's dtype. An f32 input keeps the f32 arithmetic bit for bit.
The two products of bf16 operands sum in f64 (`_half_mm`): the products of
two bf16 values are exact, so are their f64 sums at these lengths, and the
f32 result does not depend on the order cuBLAS takes, which follows the
batch (a streaming window alone and in the engine's batch parted by an f32
ulp in the P.V rows, then a bf16 rounding of the out projection's input).
"""
import math

import torch
from torch import nn

from masr_tpu_torch.models.layers import Linear
from masr_tpu_torch.ops.common import dropout
from masr_tpu_torch.ops.cuda.rel_pos_attention import rel_pos_flash_attention

NEG_INF = -1e38


def _half_mm(a, b):
    """a @ b → f32: bf16 operands (the bf16 mode) summed in f64, exactly,
    whatever the batch; any other operands as f32."""
    if a.dtype == torch.bfloat16 or b.dtype == torch.bfloat16:
        return (a.double() @ b.double()).float()
    return a.float() @ b.float()


def _mask_scores(scores, mask):
    """Softmax over keys; mask: bool (B, 1|T1, T2), True = attend. Masked
    probabilities are zeroed, so a row with no valid key gives 0."""
    m = mask[:, None, :, :]
    attn = torch.softmax(scores.masked_fill(~m, NEG_INF), dim=-1)
    return attn.masked_fill(~m, 0.0)


def cache_key_mask(cache_size, chunk_len, valid_len, batch=1, device=None):
    """(B, 1, C + chunk) bool: the last valid_len cache rows and the whole
    chunk (right-aligned cache)."""
    return slot_key_mask(cache_size, chunk_len, torch.full(
        (batch,), valid_len, dtype=torch.long, device=device))


def slot_key_mask(cache_size, chunk_len, valid_lens):
    """cache_key_mask with a valid count per slot: valid_lens (N,) int →
    (N, 1, C + chunk) bool."""
    dev = valid_lens.device
    cache_ok = torch.arange(cache_size, device=dev)[None, :] >= \
        cache_size - valid_lens.long()[:, None]
    chunk_ok = torch.ones(valid_lens.shape[0], chunk_len, dtype=torch.bool,
                          device=dev)
    return torch.cat([cache_ok, chunk_ok], dim=1)[:, None, :]


class MultiHeadedAttention(nn.Module):
    """Scaled dot-product attention of query rows over key/value rows.
    Module names follow upstream MASR."""

    def __init__(self, n_head: int, n_feat: int, dropout_rate: float = 0.0):
        super().__init__()
        assert n_feat % n_head == 0
        self.n_head, self.d_k = n_head, n_feat // n_head
        self.dropout_rate = dropout_rate
        self.linear_q = Linear(n_feat, n_feat)
        self.linear_k = Linear(n_feat, n_feat)
        self.linear_v = Linear(n_feat, n_feat)
        self.linear_out = Linear(n_feat, n_feat)

    def _heads(self, x):
        B, T, _ = x.shape
        return x.view(B, T, self.n_head, self.d_k).transpose(1, 2)

    def _attend(self, scores, mask, v, generator):
        """f32 scores → softmax, rounded to v's dtype → P.V (f32 sums)."""
        B = v.shape[0]
        attn = dropout(_mask_scores(scores, mask).to(v.dtype),
                       self.dropout_rate, self.training, generator)
        out = _half_mm(attn, v).to(v.dtype)
        out = out.transpose(1, 2).reshape(B, -1, self.n_head * self.d_k)
        return self.linear_out(out)

    def forward(self, query, key, value, mask, generator=None):
        """query (B, T1, D), key/value (B, T2, D), mask (B, 1|T1, T2) bool
        → (B, T1, D)."""
        q = self._heads(self.linear_q(query))
        k = self._heads(self.linear_k(key))
        v = self._heads(self.linear_v(value))
        scores = _half_mm(q, k.transpose(-1, -2)) / math.sqrt(self.d_k)
        return self._attend(scores, mask, v, generator)


class RelPositionMultiHeadedAttention(MultiHeadedAttention):
    """Transformer-XL rel-pos MHSA with pos_bias_u/v; rel_shift is absent,
    as in the reference. Module names follow upstream MASR."""

    def __init__(self, n_head: int, n_feat: int, dropout_rate: float = 0.0):
        super().__init__(n_head, n_feat, dropout_rate)
        self.linear_pos = Linear(n_feat, n_feat, bias=False)
        self.pos_bias_u = nn.Parameter(torch.zeros(n_head, self.d_k))
        self.pos_bias_v = nn.Parameter(torch.zeros(n_head, self.d_k))

    def flash_route(self, x, mask, cache=None):
        """The flash route's rule (module docstring): no cache, a square
        (B, T, T) mask, no attention dropout, no autograd recording."""
        if cache is not None or mask is None or mask.dim() != 3 \
                or mask.shape[1] != x.shape[1]:
            return False
        if self.training and self.dropout_rate > 0.0:
            return False
        return not (torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad
                                   for p in self.parameters())))

    def _qkv(self, x, cache=None):
        """The self-attention heads (B, h, T, d_k) of x, the keys and values
        after a right-aligned cache (B, h, C, 2·d_k) when one is given, and
        the new cache: the last C rows of [cache ‖ fresh], or None
        (masr_tpu's _qkv and _merge_cache)."""
        q = self._heads(self.linear_q(x))
        k = self._heads(self.linear_k(x))
        v = self._heads(self.linear_v(x))
        if cache is None:
            return q, k, v, None
        C = cache.shape[2]
        cache = cache.to(k.dtype)
        k = torch.cat([cache[..., :self.d_k], k], dim=2)
        v = torch.cat([cache[..., self.d_k:], v], dim=2)
        return q, k, v, torch.cat([k, v], dim=-1)[:, :, k.shape[2] - C:]

    @staticmethod
    def _rel_scores(q, k, p, bias_u, bias_v, d):
        """AC + BD as one matmul: [q+bu ‖ q+bv] · [k ‖ p]^T / √d; p may
        have a batch of 1 (shared positions) or B (per-slot positions)."""
        bias_u, bias_v = bias_u.to(q.dtype), bias_v.to(q.dtype)
        q_cat = torch.cat([q + bias_u[None, :, None, :],
                           q + bias_v[None, :, None, :]], dim=-1)
        k_cat = torch.cat([k, p.expand_as(k)], dim=-1)
        return _half_mm(q_cat, k_cat.transpose(-1, -2)) / math.sqrt(d)

    def forward(self, x, mask, pos_emb, cache=None, generator=None):
        """x: (B, T, D); mask: (B, 1|T, T2) bool; pos_emb: (1|B, T2, D)
        over the key length T2 (T, or C + T with a cache); cache: None or
        the right-aligned (B, h, C, 2·d_k) [K ‖ V] rows → (out (B, T, D),
        new cache: the last C rows of [cache ‖ fresh], or None)."""
        if self.flash_route(x, mask, cache):
            return self._flash(x, mask, pos_emb), None
        q, k, v, new_cache = self._qkv(x, cache)
        # (1|B, h, T2, d_k)
        p = self._heads(self.linear_pos(pos_emb.to(x.dtype)))
        scores = self._rel_scores(q, k, p, self.pos_bias_u, self.pos_bias_v,
                                  self.d_k)
        return self._attend(scores, mask, v, generator), new_cache

    def _flash(self, x, mask, pos_emb):
        """The flash route: heads as views of the (B, T, D) projections, so
        the kernel reads them in place and writes (B, T, D) rows."""
        B, T, D = x.shape
        q, k, v = (self._heads(f(x)) for f in (self.linear_q, self.linear_k,
                                                self.linear_v))
        p = self.linear_pos(pos_emb.to(x.dtype))[0].view(
            T, self.n_head, self.d_k).transpose(0, 1)
        out = rel_pos_flash_attention(q, k, v, p,
                                      self.pos_bias_u.to(x.dtype),
                                      self.pos_bias_v.to(x.dtype), mask,
                                      1.0 / math.sqrt(self.d_k))
        return self.linear_out(out.transpose(1, 2).reshape(B, T, D))
