"""The bf16 training layers' product alone, on the CPU
(masr_tpu_torch/ops/cuda/train_product.py): its plain twin against
masr_tpu's `_mm`, `_mm_nt`, `_mm_tn` at compute dtype bf16
(masr_tpu/ops/pallas/conformer_layer_train.py:79-95), and the operand
layouts (`geometry`) that the CUDA product reads, for the views the
attention's batched products pass. The kernel itself is held against the
twin in tests/test_torch_cuda_kernels.py.

- The twin: bf16-rounded operands summed in f32, A and B transposed or
  not, equal to masr_tpu's product within f32 sum order (1e-5 of sum |a||b|);
  its epilogue (bias, SiLU and its pre-activation, x dSiLU, the dropout
  hash's mask, the row mask, the residual, the rounding) against the same
  arithmetic written out; the CPU wrapper writes what the twin returns.
- The geometry: (ld, s1, s2, div) and the batch count of a matrix, of a
  batch, of the head views of (B, T', D) rows, of posp broadcast across
  utterances and of the padded (h, B, T', T') probabilities, as
  csrc/train_wgmma.cuh's AttBatchesBf lays them out.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masr_tpu.ops.pallas import conformer_layer_train as mt
from masr_tpu_torch.ops.cuda import train_product as tp
from masr_tpu_torch.ops.dropout_hash import dropout_mask
from test_torch_threads import one_torch_thread  # noqa: F401

BF = torch.bfloat16


def _rows(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("kind", ["nn", "nt", "tn"])
def test_plain_product_matches_masr_tpu(kind):
    """train_product_plain == masr_tpu's _mm / _mm_nt / _mm_tn at cdt
    bf16 on the same f32 inputs (each rounded to bf16 on both sides), f32
    sums within 1e-5 of sum |a||b|."""
    rng = np.random.default_rng(len(kind))
    M, N, K = 37, 24, 53
    a = _rows(rng, *((K, M) if kind == "tn" else (M, K)))
    b = _rows(rng, *((N, K) if kind == "nt" else (K, N)))
    fn = {"nn": mt._mm, "nt": mt._mm_nt, "tn": mt._mm_tn}[kind]
    want = np.asarray(fn(jnp.asarray(a), jnp.asarray(b), jnp.bfloat16))
    got, _ = tp.train_product_plain(torch.from_numpy(a).to(BF),
                                    torch.from_numpy(b).to(BF),
                                    ta=kind == "tn", tb=kind == "nt")
    ab = np.abs(np.asarray(torch.from_numpy(a).to(BF).float()))
    bb = np.abs(np.asarray(torch.from_numpy(b).to(BF).float()))
    ref = (ab.T if kind == "tn" else ab) @ (bb.T if kind == "nt" else bb)
    assert got.dtype == torch.float32
    assert np.all(np.abs(got.numpy() - want) <= 1e-5 * ref + 1e-7)


def test_plain_epilogue_arithmetic():
    """The twin's epilogue, each mode together on one product: v = alpha
    acc + bias, pre = v, x dSiLU(aux), the dropout mask of (seeds[b],
    layer, site, row0 + b, t, n), rows t >= lens[b] zero, R + res_scale
    v, rounded to bf16 values; SiLU alone on another call."""
    g = torch.Generator().manual_seed(3)
    B, T, K, N = 2, 5, 16, 8
    a = torch.randn(B * T, K, generator=g).to(BF)
    w = torch.randn(K, N, generator=g).to(BF)
    bias, R = torch.randn(N, generator=g), torch.randn(B * T, N, generator=g)
    aux = torch.randn(B * T, N, generator=g)
    seeds = torch.tensor([11, -7], dtype=torch.int32)
    lens = torch.tensor([5, 3], dtype=torch.int32)
    out, pre = tp.train_product_plain(
        a, w, bias=bias, alpha=0.5, R=R, res_scale=0.25, act=2, aux=aux,
        seeds=seeds, layer=4, site=6, rate=0.3, row0=9, lens=lens, T=T,
        round_c=True)
    v = 0.5 * (a.float() @ w.float()) + bias
    assert torch.equal(pre, v)
    s = torch.sigmoid(aux)
    v = v * (s * (1 + aux * (1 - s)))
    v = v * dropout_mask(seeds, 4, 6, torch.arange(T), torch.arange(N), 0.3,
                         9).reshape(B * T, N)
    ok = (torch.arange(B * T) % T < lens.long()[torch.arange(B * T) // T])
    v = torch.where(ok[:, None], v, 0.0)
    assert torch.equal(out, (R + 0.25 * v).to(BF).float())
    silu, _ = tp.train_product_plain(a, w, bias=bias, act=1)
    assert torch.equal(silu, torch.nn.functional.silu(
        a.float() @ w.float() + bias))


def test_cpu_wrapper_writes_the_twin():
    """On CPU tensors train_product_bf16 writes the twin's output into out
    and out_bf16 (rounded) and its pre-activation into pre; it refuses f32
    operands and a call without an output."""
    g = torch.Generator().manual_seed(5)
    a = torch.randn(6, 12, generator=g).to(BF)
    w = torch.randn(12, 10, generator=g).to(BF)
    bias = torch.randn(10, generator=g)
    out, pre = torch.empty(6, 10), torch.empty(6, 10)
    out_b = torch.empty(6, 10, dtype=BF)
    tp.train_product_bf16(a, w, out=out, out_bf16=out_b, pre=pre, bias=bias,
                          act=1)
    want, want_pre = tp.train_product_plain(a, w, bias=bias, act=1)
    assert torch.equal(out, want) and torch.equal(pre, want_pre)
    assert torch.equal(out_b, want.to(BF))
    with pytest.raises(ValueError):
        tp.train_product_bf16(a.float(), w, out=out)
    with pytest.raises(ValueError):
        tp.train_product_bf16(a, w)


def test_geometry_of_the_attention_views():
    """geometry() of the views the attention's batched products pass, as
    AttBatchesBf lays them out (batch matrix z = b H + h): q-like head
    views (s1 = T D, s2 = d_k, div H), posp broadcast across utterances
    (s1 0), the padded probabilities (rows pad8(T) apart, s1 = T Tp, s2 =
    B T Tp), the f32 scores, dposp's per-head rows over K = B T; a plain
    matrix and a one-dim batch."""
    B, T, H, dk = 3, 45, 4, 16
    D, Tp = H * dk, 48
    x = torch.zeros(B, T, D, dtype=BF)
    heads = x.view(B, T, H, dk).permute(0, 2, 1, 3)
    assert tp.geometry(heads) == ((D, T * D, dk, H), B * H)
    posp = torch.zeros(T, D, dtype=BF)
    ph = posp[None].view(1, T, H, dk).permute(0, 2, 1, 3).expand(B, H, T, dk)
    assert tp.geometry(ph) == ((D, 0, dk, H), B * H)
    pad = torch.zeros(H, B, T, Tp, dtype=BF)
    P = pad[..., :T].permute(1, 0, 2, 3)
    assert tp.geometry(P) == ((Tp, T * Tp, B * T * Tp, H), B * H)
    scores = torch.zeros(H, B, T, T).permute(1, 0, 2, 3)
    assert tp.geometry(scores) == ((T, T * T, B * T * T, H), B * H)
    dS = pad[..., :T].reshape(H, B * T, T)
    assert tp.geometry(dS) == ((Tp, B * T * Tp, 0, 1), H)
    qv = x.view(B * T, H, dk).permute(1, 0, 2)
    assert tp.geometry(qv) == ((D, dk, 0, 1), H)
    assert tp.geometry(torch.zeros(7, 9)) == ((9, 0, 0, 1), 1)
    with pytest.raises(ValueError):
        tp.geometry(torch.zeros(4, 6).t())
