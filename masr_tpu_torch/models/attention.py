"""Multi-head attention: the plain one (self and cross attention, the
attention decoder's) and rel-pos self-attention, full context and with a
streaming cache (port of masr_tpu/models/attention.py:21-28, :31-88,
:91-151 and cache_key_mask :173-178). In training mode the attention
probabilities go through dropout, drawn from the `generator` argument.

The streaming cache of this eager module is masr_tpu's: a right-aligned
fixed (B, h, C, 2·d_k) array of [K ‖ V] rows, newest last, with a count of
valid rows. It is the reference the chunk-layer kernel's ring layout is
held against (models/weights.py converts between the two).
"""
import math

import torch
from torch import nn

from masr_tpu_torch.ops.common import dropout

NEG_INF = -1e38


def _mask_scores(scores, mask):
    """Softmax over keys; mask: bool (B, 1|T1, T2), True = attend. Masked
    probabilities are zeroed, so a row with no valid key gives 0."""
    m = mask[:, None, :, :]
    attn = torch.softmax(scores.masked_fill(~m, NEG_INF), dim=-1)
    return attn.masked_fill(~m, 0.0)


def cache_key_mask(cache_size, chunk_len, valid_len, batch=1, device=None):
    """(B, 1, C + chunk) bool: the last valid_len cache rows and the whole
    chunk (right-aligned cache)."""
    cache_ok = torch.arange(cache_size, device=device) >= \
        cache_size - valid_len
    m = torch.cat([cache_ok, torch.ones(chunk_len, dtype=torch.bool,
                                        device=device)])
    return m[None, None, :].expand(batch, 1, cache_size + chunk_len)


class MultiHeadedAttention(nn.Module):
    """Scaled dot-product attention of query rows over key/value rows.
    Module names follow upstream MASR."""

    def __init__(self, n_head: int, n_feat: int, dropout_rate: float = 0.0):
        super().__init__()
        assert n_feat % n_head == 0
        self.n_head, self.d_k = n_head, n_feat // n_head
        self.dropout_rate = dropout_rate
        self.linear_q = nn.Linear(n_feat, n_feat)
        self.linear_k = nn.Linear(n_feat, n_feat)
        self.linear_v = nn.Linear(n_feat, n_feat)
        self.linear_out = nn.Linear(n_feat, n_feat)

    def _heads(self, x):
        B, T, _ = x.shape
        return x.view(B, T, self.n_head, self.d_k).transpose(1, 2)

    def _attend(self, scores, mask, v, generator):
        B = v.shape[0]
        attn = dropout(_mask_scores(scores, mask), self.dropout_rate,
                       self.training, generator)
        out = (attn @ v).transpose(1, 2).reshape(B, -1,
                                                 self.n_head * self.d_k)
        return self.linear_out(out)

    def forward(self, query, key, value, mask, generator=None):
        """query (B, T1, D), key/value (B, T2, D), mask (B, 1|T1, T2) bool
        → (B, T1, D)."""
        q = self._heads(self.linear_q(query))
        k = self._heads(self.linear_k(key))
        v = self._heads(self.linear_v(value))
        scores = q @ k.transpose(-1, -2) / math.sqrt(self.d_k)
        return self._attend(scores, mask, v, generator)


class RelPositionMultiHeadedAttention(MultiHeadedAttention):
    """Transformer-XL rel-pos MHSA with pos_bias_u/v; rel_shift is absent,
    as in the reference. Module names follow upstream MASR."""

    def __init__(self, n_head: int, n_feat: int, dropout_rate: float = 0.0):
        super().__init__(n_head, n_feat, dropout_rate)
        self.linear_pos = nn.Linear(n_feat, n_feat, bias=False)
        self.pos_bias_u = nn.Parameter(torch.zeros(n_head, self.d_k))
        self.pos_bias_v = nn.Parameter(torch.zeros(n_head, self.d_k))

    def forward(self, x, mask, pos_emb, cache=None, generator=None):
        """x: (B, T, D); mask: (B, 1|T, T2) bool; pos_emb: (1, T2, D) over
        the key length T2 (T, or C + T with a cache); cache: None or the
        right-aligned (B, h, C, 2·d_k) [K ‖ V] rows → (out (B, T, D),
        new cache: the last C rows of [cache ‖ fresh], or None)."""
        B, T, _ = x.shape
        q = self._heads(self.linear_q(x))
        k = self._heads(self.linear_k(x))
        v = self._heads(self.linear_v(x))
        new_cache = None
        if cache is not None:                     # _merge_cache
            C = cache.shape[2]
            k = torch.cat([cache[..., :self.d_k], k], dim=2)
            v = torch.cat([cache[..., self.d_k:], v], dim=2)
            new_cache = torch.cat([k, v], dim=-1)[:, :, k.shape[2] - C:]
        p = self._heads(self.linear_pos(pos_emb))           # (1, h, T2, d_k)
        # AC + BD as one matmul: [q+bu ‖ q+bv] · [k ‖ p]^T
        q_cat = torch.cat([q + self.pos_bias_u[None, :, None, :],
                           q + self.pos_bias_v[None, :, None, :]], dim=-1)
        k_cat = torch.cat([k, p.expand_as(k)], dim=-1)
        scores = q_cat @ k_cat.transpose(-1, -2) / math.sqrt(self.d_k)
        return self._attend(scores, mask, v, generator), new_cache
