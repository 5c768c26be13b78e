"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Needs an NVIDIA Hopper GPU and nvcc; every test skips without a card. It
imports neither JAX nor masr_tpu, so it runs on a machine without them:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""
import pytest
import torch

from masr_tpu_torch.models.conformer import ConformerEncoderLayer
from masr_tpu_torch.models.embedding import sinusoid_position_encoding
from masr_tpu_torch.models.weights import seeded_state_dict
from masr_tpu_torch.ops.cuda import chunk_layer as ck
from masr_tpu_torch.ops.cuda import conformer_layer as cl


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (d_model, heads, ffn, conv kernel, T, lens): the test widths, the tiny
# example bundle's (d_k = 24, not a multiple of 32) and the flagship's
SHAPES = [(64, 2, 96, 7, 45, [45, 36, 0]),
          (48, 2, 96, 7, 37, [37, 20, 5]),
          (256, 4, 2048, 15, 299, [299, 282, 5, 0])]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"D{s[0]}T{s[4]}")
def test_conformer_layer_kernel_matches_plain(cuda_device, shape, causal):
    """fused_conformer_layer (CUDA) == fused_conformer_layer_plain on the
    same card, valid rows, atol 2e-4 (f32 FMA, different sum order); the
    output is finite everywhere and the call counts one launch."""
    D, H, FF, K, T, lens = shape
    layer = ConformerEncoderLayer(D, H, FF, cnn_module_kernel=K,
                                  causal=causal)
    layer.load_state_dict(seeded_state_dict(layer, seed=D + T))
    layer = layer.to(cuda_device)
    g = torch.Generator().manual_seed(T)
    x = torch.randn(len(lens), T, D, generator=g).to(cuda_device)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    with torch.no_grad():
        pos_p = layer.self_attn.linear_pos(sinusoid_position_encoding(
            torch.arange(T, device=cuda_device), D))
        packed = cl.pack_layer_params(layer)
        before = cl.fused_conformer_layer.launches
        got = cl.fused_conformer_layer(x, lens_t, pos_p, packed, n_head=H,
                                       ksize=K, causal=causal)
        want = cl.fused_conformer_layer_plain(x, lens_t, pos_p, packed,
                                              n_head=H, ksize=K,
                                              causal=causal)
    torch.cuda.synchronize()
    assert cl.fused_conformer_layer.launches == before + 1
    assert torch.isfinite(got).all()
    for b, n in enumerate(lens):
        err = (got[b, :n] - want[b, :n]).abs().max().item() if n else 0.0
        assert err <= 2e-4, (b, n, err)


# (d_model, heads, ffn, conv kernel, chunk c, cache C): the test widths, the
# example bundle's (d_k = 24) and the flagship's engine shape
CHUNK_SHAPES = [(64, 2, 96, 7, 8, 32), (48, 2, 96, 7, 16, 256),
                (256, 4, 2048, 15, 16, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["exact", "table"])
@pytest.mark.parametrize("n_sub", [1, 2])
@pytest.mark.parametrize("shape", CHUNK_SHAPES, ids=lambda s: f"D{s[0]}C{s[5]}")
def test_chunk_layer_kernel_matches_plain(cuda_device, shape, n_sub, route):
    """fused_chunk_layer (CUDA) == fused_chunk_layer_plain on the same card:
    outputs and updated caches atol 2e-4 (f32 FMA, different sum order),
    over slots mixing cache_len {0, partial, full}, different write
    pointers and offsets; inactive slots' caches stay bitwise unchanged;
    the call counts one launch."""
    D, H, FF, K, c, C = shape
    c *= n_sub
    d_k, L = D // H, C + c
    layer = ConformerEncoderLayer(D, H, FF, cnn_module_kernel=K, causal=True)
    layer.load_state_dict(seeded_state_dict(layer, seed=D + C + c))
    layer = layer.to(cuda_device)
    g = torch.Generator().manual_seed(c + C)
    x = torch.randn(6, c, D, generator=g).to(cuda_device)
    att = (0.5 * torch.randn(6, H, C, 2 * d_k, generator=g)).to(cuda_device)
    cnn = (0.5 * torch.randn(6, K - 1, D, generator=g)).to(cuda_device)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=cuda_device)

    clens = i32([0, 5, min(100, C), C, C, 3])
    wptrs = i32([0, 3, 7 % C, C - 1, 11 % C, 0])
    active = i32([1, 1, 1, 1, 0, 0])
    offsets = [0, 5, 100, 400, 250, 3]
    with torch.no_grad():
        if route == "table":
            pos = ck.make_chunk_pos_table(layer.self_attn.linear_pos.weight,
                                          C, table_len=1024)
            starts = ck.clamp_pos_starts(i32(offsets), 1024, L)
        else:
            rows = torch.clamp(i32(offsets)[:, None] - C
                               + torch.arange(L, device=cuda_device), min=0)
            pos = layer.self_attn.linear_pos(
                sinusoid_position_encoding(rows.reshape(-1), D))
            starts = torch.arange(6, dtype=torch.int32,
                                  device=cuda_device) * L
        packed = cl.pack_layer_params(layer)
        caches = {}
        for name, fn in (("kernel", ck.fused_chunk_layer),
                         ("plain", ck.fused_chunk_layer_plain)):
            a, n = att.clone(), cnn.clone()
            before = ck.fused_chunk_layer.launches
            out = fn(x, pos, starts, a, n, clens, wptrs, active, packed,
                     n_head=H, ksize=K, n_sub=n_sub)
            caches[name] = (out, a, n, ck.fused_chunk_layer.launches - before)
    torch.cuda.synchronize()
    (got, a_k, n_k, launched), (want, a_p, n_p, _) = (caches["kernel"],
                                                      caches["plain"])
    assert launched == 1
    assert torch.isfinite(got).all()
    for name, k_t, p_t in (("out", got, want), ("att", a_k, a_p),
                           ("cnn", n_k, n_p)):
        err = (k_t - p_t).abs().max().item()
        assert err <= 2e-4, (name, err)
    assert torch.equal(a_k[4:], att[4:]) and torch.equal(n_k[4:], cnn[4:])
    assert not torch.equal(a_k[:4], att[:4])
