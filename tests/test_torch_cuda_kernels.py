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


def _rel_err(got, want):
    """max |got - want| over max |want| (1 where want is all 0)."""
    scale = max(want.abs().max().item(), 1e-30)
    return (got - want).abs().max().item() / scale


# (d_model, heads, ffn, conv kernel, T, lens): test widths and the flagship
TRAIN_SHAPES = [(64, 2, 96, 7, 45, [45, 36, 0]),
                (256, 4, 2048, 15, 299, [299, 250, 180, 120, 64, 33, 17, 5])]


@pytest.mark.cuda
@pytest.mark.parametrize("rates", [(0.0, 0.0), (0.1, 0.1)],
                         ids=["drop0", "drop0.1"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", TRAIN_SHAPES, ids=lambda s: f"D{s[0]}T{s[4]}")
def test_train_layer_kernel_matches_plain(cuda_device, shape, causal, rates):
    """fused_conformer_layer_train (CUDA forward + backward) == the plain
    twin with autograd on the same card, same dropout hash: output max abs
    err 2e-4; the grads of sum(y * w) wrt x, posp and every packed array
    each within 1e-4 of the plain grad's largest magnitude (f32, other sum
    order over up to B*T' rows); one forward and one backward launch."""
    from masr_tpu_torch.ops.cuda import conformer_layer_train as clt
    D, H, FF, K, T, lens = shape
    rate, att_rate = rates
    B = len(lens)
    layer = ConformerEncoderLayer(D, H, FF, cnn_module_kernel=K,
                                  causal=causal)
    layer.load_state_dict(seeded_state_dict(layer, seed=D + T + 1))
    layer = layer.to(cuda_device)
    g = torch.Generator().manual_seed(T + 5)
    x = torch.randn(B, T, D, generator=g).to(cuda_device)
    w = torch.randn(B, T, D, generator=g).to(cuda_device)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    r = torch.arange(T, device=cuda_device)
    mask = ((r[None, :] // 16) <= (r[:, None] // 16))[None] & \
        (r[None, None, :] < lens_t[:, None, None])
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (B,), generator=g,
                          dtype=torch.int32).to(cuda_device)
    posp0 = layer.self_attn.linear_pos(sinusoid_position_encoding(
        r, D)).detach()
    packed0 = {k: v.detach() for k, v in cl.pack_layer_params(layer).items()}
    results = {}
    for name, fn in (("kernel", clt.fused_conformer_layer_train),
                     ("plain", clt.fused_conformer_layer_train_plain)):
        xx = x.clone().requires_grad_(True)
        pp = posp0.clone().requires_grad_(True)
        pk = {k: v.clone().requires_grad_(True) for k, v in packed0.items()}
        before = clt.fused_conformer_layer_train.launches
        y = fn(xx, mask, seeds, lens_t, pp, pk, layer=3, n_head=H, ksize=K,
               causal=causal, rate=rate, att_rate=att_rate)
        (y * w).sum().backward()
        torch.cuda.synchronize()
        results[name] = (y.detach(), xx.grad, pp.grad,
                         {k: v.grad for k, v in pk.items()},
                         clt.fused_conformer_layer_train.launches - before)
    (y_k, dx_k, dp_k, dw_k, n_k), (y_p, dx_p, dp_p, dw_p, _) = \
        results["kernel"], results["plain"]
    assert n_k == 2
    assert torch.isfinite(y_k).all() and torch.isfinite(dx_k).all()
    assert (y_k - y_p).abs().max().item() <= 2e-4
    for name, a, b in [("x", dx_k, dx_p), ("posp", dp_k, dp_p)] + [
            (k, dw_k[k], dw_p[k]) for k in dw_p]:
        assert torch.isfinite(a).all(), name
        assert _rel_err(a, b) <= 1e-4, (name, _rel_err(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,V,L", [(4, 37, 23, 9), (8, 299, 4000, 80)])
def test_ctc_kernel_matches_plain(cuda_device, B, T, V, L):
    """ctc_loss (CUDA forward + backward) == ctc_loss_plain on the same
    card: per-sequence NLL rtol 1e-5; the logits grad of a weighted sum
    within max(2x the plain twin's f32 error, 1e-4) of the plain twin in
    f64 (f32 log-space sums over T frames with |log Z| ~ 1e3 leave ~1e-3
    in the occupancies, in both f32 versions); label lengths from 0 to L (S = 2L + 1 up to 161, past the
    TPU kernel's 128-state cap), repeats, padded frames; one forward and
    one backward launch."""
    from masr_tpu_torch.ops.cuda import ctc_loss as C
    g = torch.Generator().manual_seed(B + T)
    logits = (2 * torch.randn(B, T, V, generator=g)).to(cuda_device)
    labels = torch.randint(1, min(V, 6) if B == 4 else V, (B, L),
                           generator=g)
    label_lens = torch.linspace(0, L, B).round().to(torch.int32)
    logit_lens = torch.clamp(T - 3 * torch.arange(B), min=2 * L + 1)
    labels[torch.arange(L)[None] >= label_lens[:, None]] = -1
    wts = torch.randn(B, generator=g).to(cuda_device)
    args = (logit_lens.to(cuda_device), labels.to(cuda_device),
            label_lens.to(cuda_device))
    out = {}
    for name, fn, dtype in (("kernel", C.ctc_loss, torch.float32),
                            ("plain", C.ctc_loss_plain, torch.float32),
                            ("f64", C.ctc_loss_plain, torch.float64)):
        lg = logits.detach().to(dtype).clone().requires_grad_(True)
        before = C.ctc_loss.launches
        nll = fn(lg, *args)
        (nll * wts.to(dtype)).sum().backward()
        torch.cuda.synchronize()
        out[name] = (nll.detach().double(), lg.grad.double(),
                     C.ctc_loss.launches - before)
    (n_k, g_k, launched), (n_p, g_p, _), (_, g_64, _) = (
        out["kernel"], out["plain"], out["f64"])
    assert launched == 2
    assert torch.isfinite(n_k).all() and torch.isfinite(g_k).all()
    torch.testing.assert_close(n_k, n_p, rtol=1e-5, atol=1e-4)
    k64 = (g_k - g_64).abs().max().item()
    p64 = (g_p - g_64).abs().max().item()
    assert k64 <= max(2 * p64, 1e-4), (k64, p64)


# --------------------------------------------------------------------------- #
# Squeezeformer
# --------------------------------------------------------------------------- #
def _sq_layer(D, H, FF, K, causal, conv_norm, seed, device):
    from masr_tpu_torch.models.squeezeformer import SqueezeformerEncoderLayer
    layer = SqueezeformerEncoderLayer(D, H, FF, K, conv_norm, causal)
    layer.load_state_dict(seeded_state_dict(layer, seed=seed))
    return layer.to(device).eval()


# (d_model, heads, ffn, conv kernel, T, lens): the test widths and the
# flagship's (configs/squeezeformer.yml) at full and half rate
SQ_SHAPES = [(64, 2, 128, 7, 45, [45, 36, 0]),
             (256, 4, 2048, 31, 299, [299, 282, 5, 0]),
             (256, 4, 2048, 31, 150, [150, 141, 3, 1])]


@pytest.mark.cuda
@pytest.mark.parametrize("conv_norm", ["batch_norm", "layer_norm"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SQ_SHAPES, ids=lambda s: f"D{s[0]}T{s[4]}")
def test_squeezeformer_layer_kernel_matches_plain(cuda_device, shape, causal,
                                                  conv_norm):
    """fused_squeezeformer_layer (CUDA) == its plain twin on the same card,
    valid rows, atol 2e-4 (f32 FMA, different sum order); the output is
    finite everywhere and the call counts one launch."""
    from masr_tpu_torch.ops.cuda import squeezeformer_layer as sq
    D, H, FF, K, T, lens = shape
    layer = _sq_layer(D, H, FF, K, causal, conv_norm, D + T, cuda_device)
    g = torch.Generator().manual_seed(T + 1)
    x = torch.randn(len(lens), T, D, generator=g).to(cuda_device)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    kw = dict(n_head=H, ksize=K, causal=causal,
              conv_ln=conv_norm == "layer_norm")
    with torch.no_grad():
        pos_p = layer.self_attn.linear_pos(sinusoid_position_encoding(
            torch.arange(T, device=cuda_device), D))
        packed = layer.packed_params()
        before = sq.fused_squeezeformer_layer.launches
        got = sq.fused_squeezeformer_layer(x, lens_t, pos_p, packed, **kw)
        want = sq.fused_squeezeformer_layer_plain(x, lens_t, pos_p, packed,
                                                  **kw)
    torch.cuda.synchronize()
    assert sq.fused_squeezeformer_layer.launches == before + 1
    assert torch.isfinite(got).all()
    for b, n in enumerate(lens):
        err = (got[b, :n] - want[b, :n]).abs().max().item() if n else 0.0
        assert err <= 2e-4, (b, n, err)


# (d_model, heads, ffn, conv kernel, chunk c, cache C) at full rate: the
# test widths and the flagship's streaming shape
SQ_CHUNK_SHAPES = [(64, 2, 128, 7, 16, 64), (256, 4, 2048, 31, 16, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("rep", [1, 2], ids=["full_rate", "half_rate"])
@pytest.mark.parametrize("n_sub", [1, 2])
@pytest.mark.parametrize("shape", SQ_CHUNK_SHAPES,
                         ids=lambda s: f"D{s[0]}C{s[5]}")
def test_chunk_layer_sq_kernel_matches_plain(cuda_device, shape, n_sub, rep):
    """fused_chunk_layer_sq (CUDA) == its plain twin on the same card, at
    full rate and at half rate on the full-resolution ring (rows stored
    twice): outputs and updated caches atol 2e-4, over slots mixing
    cache_len {0, partial, full} and write pointers that wrap; inactive
    slots' caches stay bitwise unchanged; one launch."""
    from masr_tpu_torch.ops.cuda import chunk_layer_sq as cks
    D, H, FF, K, c, C = shape
    c, C = c * n_sub // rep, C // rep
    d_k, L = D // H, C + c
    layer = _sq_layer(D, H, FF, K, True, "batch_norm", D + C + c,
                      cuda_device)
    g = torch.Generator().manual_seed(c + C)
    x = torch.randn(6, c, D, generator=g).to(cuda_device)
    att = (0.5 * torch.randn(6, H, C * rep, 2 * d_k, generator=g)).to(
        cuda_device)
    cnn = (0.5 * torch.randn(6, K - 1, D, generator=g)).to(cuda_device)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=cuda_device)

    clens = i32([0, 5, C // 2, C, C, 3])
    wptrs = i32([0, 3, C - 2, C - 1, 11 % C, 0])
    active = i32([1, 1, 1, 1, 0, 0])
    offsets = [0, 5, 100, 400, 250, 3]
    with torch.no_grad():
        rows = torch.clamp(i32(offsets)[:, None] - C
                           + torch.arange(L, device=cuda_device), min=0)
        pos = layer.self_attn.linear_pos(
            sinusoid_position_encoding(rows.reshape(-1), D))
        starts = torch.arange(6, dtype=torch.int32, device=cuda_device) * L
        packed = layer.packed_params()
        res = {}
        for name, fn in (("kernel", cks.fused_chunk_layer_sq),
                         ("plain", cks.fused_chunk_layer_sq_plain)):
            a, n = att.clone(), cnn.clone()
            before = cks.fused_chunk_layer_sq.launches
            out = fn(x, pos, starts, a, n, clens, wptrs, active, packed,
                     n_head=H, ksize=K, conv_ln=False, n_sub=n_sub, rep=rep)
            res[name] = (out, a, n, cks.fused_chunk_layer_sq.launches - before)
    torch.cuda.synchronize()
    (got, a_k, n_k, launched), (want, a_p, n_p, _) = (res["kernel"],
                                                      res["plain"])
    assert launched == 1
    assert torch.isfinite(got).all()
    for name, k_t, p_t in (("out", got, want), ("att", a_k, a_p),
                           ("cnn", n_k, n_p)):
        err = (k_t - p_t).abs().max().item()
        assert err <= 2e-4, (name, err)
    assert torch.equal(a_k[4:], att[4:]) and torch.equal(n_k[4:], cnn[4:])
    assert not torch.equal(a_k[:4], att[:4])


@pytest.mark.cuda
def test_squeezeformer_flagship_launches(cuda_device):
    """The flagship Squeezeformer (configs/squeezeformer.yml widths, 12
    blocks, seeded weights): one full-context encoder call launches the
    layer kernel 12 times, one chunk step (and one two-chunk step over 4
    slots) the chunk kernel 12 times, and nothing else of the two."""
    from masr_tpu_torch.models.registry import build_model
    from masr_tpu_torch.ops.cuda import chunk_layer_sq as cks
    from masr_tpu_torch.ops.cuda import squeezeformer_layer as sq
    enc = dict(encoder_dim=256, output_size=256, attention_heads=4,
               num_blocks=12, reduce_idx=5, recover_idx=11,
               feed_forward_expansion_factor=8, cnn_module_kernel=31)
    model = build_model("squeezeformer", 80, 100, streaming=True,
                        encoder_conf=enc)
    model.load_state_dict(seeded_state_dict(model, seed=3))
    model = model.to(cuda_device).eval()
    g = torch.Generator().manual_seed(4)
    speech = torch.randn(2, 301, 80, generator=g).to(cuda_device)
    with torch.no_grad():
        counts = []
        for run in (
                lambda: model.get_encoder_out(
                    speech, torch.tensor([301, 200], device=cuda_device)),
                lambda: model.get_encoder_out_chunk(
                    speech[:1, :67], model.encoder.init_cache(
                        1, 256, cuda_device)),
                lambda: model.get_encoder_out_chunk_batched(
                    torch.randn(4, 2, 67, 80, generator=g).to(cuda_device),
                    model.encoder.init_cache(4, 256, cuda_device))):
            before = (sq.fused_squeezeformer_layer.launches,
                      cks.fused_chunk_layer_sq.launches)
            out = run()
            torch.cuda.synchronize()
            counts.append((sq.fused_squeezeformer_layer.launches - before[0],
                           cks.fused_chunk_layer_sq.launches - before[1]))
            assert torch.isfinite(out[0] if isinstance(out, tuple)
                                  else out).all()
    assert counts == [(12, 0), (0, 12), (0, 12)]


# (d_model, heads, ffn, conv kernel, T, lens, half): the test widths, and
# the flagship's (configs/squeezeformer.yml) at full rate (T'=299) and at
# half rate (T'=150 with the 299-frame mask's [::2, ::2] rows and columns
# and the lengths halved rounding up, as after the time reduction)
SQ_TRAIN_SHAPES = [(64, 2, 128, 7, 45, [45, 36, 0], False),
                   (256, 4, 2048, 31, 299,
                    [299, 281, 250, 220, 180, 150, 90, 33], False),
                   (256, 4, 2048, 31, 299,
                    [299, 281, 250, 220, 180, 150, 90, 33], True)]


@pytest.mark.cuda
@pytest.mark.parametrize("rates", [(0.0, 0.0), (0.1, 0.1)],
                         ids=["drop0", "drop0.1"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SQ_TRAIN_SHAPES,
                         ids=["D64T45", "D256T299", "D256T150half"])
def test_sq_train_layer_kernel_matches_plain(cuda_device, shape, causal,
                                             rates):
    """fused_squeezeformer_layer_train (CUDA forward + backward) == the
    plain twin with autograd on the same card, same dropout hash, a
    dynamic-chunk mask (16-frame chunks, 4 left) with padding: output max
    abs err 2e-4; the grads of sum(y * w) wrt x, posp and every packed
    array each within 1e-4 of the plain grad's largest magnitude; one
    forward and one backward launch."""
    from masr_tpu_torch.ops.cuda import squeezeformer_layer_train as sqt
    from masr_tpu_torch.ops.cuda.squeezeformer_layer import \
        pack_sq_layer_params
    D, H, FF, K, T, lens, half = shape
    rate, att_rate = rates
    B = len(lens)
    layer = _sq_layer(D, H, FF, K, causal, "layer_norm", D + T + 2,
                      cuda_device)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    r = torch.arange(T, device=cuda_device)
    rc, cc = r[:, None] // 16, r[None, :] // 16
    mask = ((cc <= rc) & (cc >= rc - 4))[None] & \
        (r[None, None, :] < lens_t[:, None, None])
    if half:
        mask, lens_t, T = mask[:, ::2, ::2], (lens_t + 1) // 2, (T + 1) // 2
    g = torch.Generator().manual_seed(T + 7)
    x = torch.randn(B, T, D, generator=g).to(cuda_device)
    w = torch.randn(B, T, D, generator=g).to(cuda_device)
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (B,), generator=g,
                          dtype=torch.int32).to(cuda_device)
    with torch.no_grad():
        posp0 = layer.self_attn.linear_pos(sinusoid_position_encoding(
            torch.arange(T, device=cuda_device), D))
        packed0 = pack_sq_layer_params(layer)
    results = {}
    for name, fn in (("kernel", sqt.fused_squeezeformer_layer_train),
                     ("plain", sqt.fused_squeezeformer_layer_train_plain)):
        xx = x.clone().requires_grad_(True)
        pp = posp0.clone().requires_grad_(True)
        pk = {k: v.clone().requires_grad_(True) for k, v in packed0.items()}
        before = sqt.fused_squeezeformer_layer_train.launches
        y = fn(xx, mask, seeds, lens_t, pp, pk, layer=6, n_head=H, ksize=K,
               causal=causal, rate=rate, att_rate=att_rate)
        (y * w).sum().backward()
        torch.cuda.synchronize()
        results[name] = (y.detach(), xx.grad, pp.grad,
                         {k: v.grad for k, v in pk.items()},
                         sqt.fused_squeezeformer_layer_train.launches - before)
    (y_k, dx_k, dp_k, dw_k, n_k), (y_p, dx_p, dp_p, dw_p, _) = \
        results["kernel"], results["plain"]
    assert n_k == 2
    assert torch.isfinite(y_k).all() and torch.isfinite(dx_k).all()
    assert (y_k - y_p).abs().max().item() <= 2e-4
    for name, a, b in [("x", dx_k, dx_p), ("posp", dp_k, dp_p)] + [
            (k, dw_k[k], dw_p[k]) for k in dw_p]:
        assert torch.isfinite(a).all(), name
        assert _rel_err(a, b) <= 1e-4, (name, _rel_err(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("conv_norm", ["layer_norm", "batch_norm"])
def test_squeezeformer_training_launches(cuda_device, conv_norm):
    """One training loss and backward of a 12-block Squeezeformer at the
    flagship widths: with the layer_norm conv every layer launches the
    training-layer kernel once forward and once backward (12 + 12) and the
    CTC kernel runs once each way; the BatchNorm conv trains through the
    eager layers (0 launches) and moves its running statistics."""
    from masr_tpu_torch.models.registry import build_model
    from masr_tpu_torch.ops.cuda import ctc_loss as C
    from masr_tpu_torch.ops.cuda import squeezeformer_layer_train as sqt
    enc = dict(encoder_dim=256, output_size=256, attention_heads=4,
               num_blocks=12, reduce_idx=5, recover_idx=11,
               feed_forward_expansion_factor=8, cnn_module_kernel=31,
               cnn_norm_type=conv_norm)
    model = build_model("squeezeformer", 80, 100, streaming=True,
                        encoder_conf=enc,
                        decoder_conf=dict(attention_heads=4,
                                          linear_units=1024, num_blocks=1,
                                          r_num_blocks=1),
                        model_conf=dict(ctc_weight=0.3, reverse_weight=0.3))
    model.load_state_dict(seeded_state_dict(model, seed=5))
    model = model.to(cuda_device).train()
    g = torch.Generator().manual_seed(6)
    speech = torch.randn(2, 301, 80, generator=g).to(cuda_device)
    text = torch.randint(1, 99, (2, 7), generator=g).to(cuda_device)
    text[1, 4:] = -1
    stats = [m.running_var.clone() for m in model.modules()
             if isinstance(m, torch.nn.BatchNorm1d)]
    before = (sqt.fused_squeezeformer_layer_train.launches,
              sqt.fused_squeezeformer_layer_train.backward_launches,
              C.ctc_loss.launches)
    out = model(speech, torch.tensor([301, 200], device=cuda_device), text,
                torch.tensor([7, 4], device=cuda_device),
                generator=torch.Generator(cuda_device).manual_seed(7),
                chunk_generator=torch.Generator().manual_seed(8))
    out["loss"].backward()
    torch.cuda.synchronize()
    counts = (sqt.fused_squeezeformer_layer_train.launches - before[0],
              sqt.fused_squeezeformer_layer_train.backward_launches
              - before[1], C.ctc_loss.launches - before[2])
    assert torch.isfinite(out["loss"])
    if conv_norm == "layer_norm":
        assert counts == (24, 12, 2) and not stats
    else:
        assert counts == (0, 0, 2) and len(stats) == 12
        moved = [m.running_var for m in model.modules()
                 if isinstance(m, torch.nn.BatchNorm1d)]
        assert all(not torch.equal(a, b) for a, b in zip(stats, moved))
