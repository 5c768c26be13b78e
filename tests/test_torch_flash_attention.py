"""The port's masked rel-pos flash attention (masr_tpu_torch/ops/cuda/
rel_pos_attention.py) against masr_tpu's, on the CPU:

- the plain twin `rel_pos_attention_plain` (what `rel_pos_flash_attention`
  runs for CPU tensors) against the Pallas kernel `rel_pos_flash_attention`
  in interpret mode and against `rel_pos_attention_reference`, every row,
  rows that see no key included (0 in all three), atol 2e-5 (f32, another
  sum order; tests/test_pallas_attention.py's tolerance), over a full mask,
  a static chunk of 8 with padding, limited left chunks and the [::2, ::2]
  of a chunk mask, at T = 37 and 96 (no multiple of a tile) and d_k = 16
  and 64;
- the attention module's flash route (the twin on the CPU) against its
  eager code under the same weights, atol 1e-6; and the route rule: under
  autograd, with a cache, a (B, 1, T) mask or attention dropout in
  training, the module keeps its eager code.
The CUDA kernel is held against the twin in tests/test_torch_cuda_kernels.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from masr_tpu.ops.pallas.attention import (rel_pos_attention_reference,
                                           rel_pos_flash_attention as pallas)
from masr_tpu_torch.models.attention import RelPositionMultiHeadedAttention
from masr_tpu_torch.models import attention as attention_module
from masr_tpu_torch.ops.cuda import rel_pos_attention as rpa
from masr_tpu_torch.ops.masks import add_optional_chunk_mask, make_pad_mask
from test_torch_threads import one_torch_thread  # noqa: F401


def _mask(kind, T, lens):
    """(B, T, T) bool mask of one kind, built by the port's mask code."""
    if kind == "half_rate":
        full = _mask("static8_pad", 2 * T, [2 * n for n in lens])
        return full[:, ::2, ::2]
    pad = ~make_pad_mask(torch.tensor(lens), T)[:, None, :]
    if kind == "full":
        return add_optional_chunk_mask(T, pad, False, False, -1, 0, -1)
    left = 1 if kind == "left_chunks" else -1
    return add_optional_chunk_mask(T, pad, False, False, -1, 8, left)


def _inputs(B, H, T, d, seed):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.standard_normal((B, H, T, d)).astype(np.float32)
               for _ in range(3))
    p = rs.standard_normal((H, T, d)).astype(np.float32)
    bu, bv = ((0.1 * rs.standard_normal((H, d))).astype(np.float32)
              for _ in range(2))
    return q, k, v, p, bu, bv


@pytest.mark.parametrize("T,d", [(37, 16), (96, 64)])
@pytest.mark.parametrize("kind", ["full", "static8_pad", "left_chunks",
                                  "half_rate"])
def test_plain_matches_pallas_and_reference(kind, T, d):
    """Every row of every utterance, the one of length 0 too; rows that see
    no key are 0 in all three."""
    lens = [T, T - 21, 0]
    mask = _mask(kind, T, lens)
    assert mask.shape == (3, T, T)
    q, k, v, p, bu, bv = _inputs(3, 2, T, d, seed=T + d)
    got = rpa.rel_pos_attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v, p, bu, bv)), mask).numpy()
    jargs = [jnp.asarray(a) for a in (q, k, v, p, bu, bv)] + \
        [jnp.asarray(mask.numpy())]
    want = np.asarray(pallas(*jargs, interpret=True))
    ref = np.asarray(rel_pos_attention_reference(*jargs))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)
    empty = ~mask.numpy().any(-1)                      # (B, T) rows
    assert empty[2].all()
    if kind == "left_chunks":
        assert empty[1].any()             # padded rows past the left chunks
    for out in (got, want, ref):
        assert np.all(out.transpose(0, 2, 1, 3)[empty] == 0.0)
    # the CPU wrapper is the twin, and launches nothing
    before = rpa.rel_pos_flash_attention.launches
    routed = rpa.rel_pos_flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v, p, bu, bv)), mask)
    np.testing.assert_array_equal(routed.numpy(), got)
    assert rpa.rel_pos_flash_attention.launches == before


def _module(seed, D=64, H=2):
    torch.manual_seed(seed)
    att = RelPositionMultiHeadedAttention(H, D, dropout_rate=0.1)
    with torch.no_grad():
        for prm in att.parameters():
            prm.add_(0.1 * torch.randn_like(prm))
    return att.eval()


def test_module_flash_route_matches_eager():
    """Under no_grad the routed call (the twin on the CPU) equals the eager
    code (taken under autograd) at 1e-6, rows with no visible key 0."""
    att = _module(0)
    T, lens = 45, [45, 30, 0]
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, T, 64, generator=g)
    pos = torch.randn(1, T, 64, generator=g)
    for kind in ("static8_pad", "left_chunks"):
        mask = _mask(kind, T, lens)
        with torch.no_grad():
            assert att.flash_route(x, mask)
            routed, cache = att(x, mask, pos)
        assert cache is None
        assert not att.flash_route(x, mask)                 # autograd on
        eager = att(x, mask, pos)[0].detach()
        np.testing.assert_allclose(routed.numpy(), eager.numpy(), atol=1e-6,
                                   rtol=0)
        empty = ~mask.any(-1)
        assert torch.all(routed[empty] == att.linear_out.bias)


def test_route_rule(monkeypatch):
    """The module calls the kernel's wrapper exactly when flash_route
    holds; under autograd (a parameter requiring grad, or the input) it
    keeps the eager code, and the wrapper's counter stays 0 on the CPU."""
    calls = []
    orig = attention_module.rel_pos_flash_attention

    def spy(*args):
        calls.append(args[0].shape)
        return orig(*args)

    monkeypatch.setattr(attention_module, "rel_pos_flash_attention", spy)
    att = _module(2)
    T = 24
    x = torch.randn(2, T, 64)
    pos = torch.randn(1, T, 64)
    mask = _mask("static8_pad", T, [24, 13])
    before = rpa.rel_pos_flash_attention.launches
    att(x, mask, pos)                                       # autograd records
    assert calls == []
    with torch.no_grad():
        att(x, mask, pos)
        assert len(calls) == 1
        # a (B, 1, T) mask, a cache: eager
        att(x, mask[:, :1], pos)
        att(x, mask[:, :, :T], pos, cache=torch.zeros(2, 2, 0, 64))
        assert len(calls) == 1
        # attention dropout in training: eager; training at rate 0: routed
        att.train()
        assert not att.flash_route(x, mask)
        att.dropout_rate = 0.0
        assert att.flash_route(x, mask)
        att.eval()
    with torch.enable_grad():
        for prm in att.parameters():
            prm.requires_grad_(False)
        assert att.flash_route(x, mask)                     # nothing records
        assert not att.flash_route(x.requires_grad_(True), mask)
    assert rpa.rel_pos_flash_attention.launches == before
