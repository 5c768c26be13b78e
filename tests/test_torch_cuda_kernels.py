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
# (T'=299: score rows of 299 floats, not 16-byte aligned; T'=300: aligned)
TRAIN_SHAPES = [(64, 2, 96, 7, 45, [45, 36, 0]),
                (256, 4, 2048, 15, 299, [299, 250, 180, 120, 64, 33, 17, 5]),
                (256, 4, 2048, 15, 300, [300, 251, 180, 120, 64, 33, 17, 5])]


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


def _ctc_run(fn, dtype, logits, args, wts, grad=True):
    """One CTC call on the card: → (nll f64, grad f64 or None, launches)."""
    from masr_tpu_torch.ops.cuda import ctc_loss as C
    lg = logits.detach().to(dtype).clone().requires_grad_(grad)
    before = C.ctc_loss.launches
    nll = fn(lg, *args)
    g = None
    if grad:
        (g,) = torch.autograd.grad((nll * wts.to(dtype)).sum(), lg)
        g = g.double()
    torch.cuda.synchronize()
    return nll.detach().double(), g, C.ctc_loss.launches - before


def _ctc_gates(device, logits, logit_lens, labels, label_lens, seed,
               rows=None):
    """The card's CTC gates on one batch: one forward and one backward
    launch; NLL vs the plain twin rtol 1e-5 atol 1e-4; grad (over `rows`,
    all by default) within max(2 x the plain f32 twin's error, 1e-4) of the
    plain twin in f64; everything finite. → the kernel's (nll, grad)."""
    from masr_tpu_torch.ops.cuda import ctc_loss as C
    wts = torch.randn(logits.shape[0], generator=torch.Generator(
        ).manual_seed(seed)).to(device)
    args = (logit_lens.to(device), labels.to(device, torch.int32),
            label_lens.to(device, torch.int32))
    logits = logits.to(device)
    n_k, g_k, launched = _ctc_run(C.ctc_loss, torch.float32, logits, args,
                                  wts)
    n_p, g_p, _ = _ctc_run(C.ctc_loss_plain, torch.float32, logits, args,
                           wts)
    _, g_64, _ = _ctc_run(C.ctc_loss_plain, torch.float64, logits, args, wts)
    assert launched == 2
    assert torch.isfinite(n_k).all() and torch.isfinite(g_k).all()
    torch.testing.assert_close(n_k, n_p, rtol=1e-5, atol=1e-4)
    rows = slice(None) if rows is None else rows
    k64 = (g_k - g_64)[rows].abs().max().item()
    p64 = (g_p - g_64)[rows].abs().max().item()
    assert k64 <= max(2 * p64, 1e-4), (k64, p64)
    return n_k, g_k


def _ctc_batch(seed, B, T, V, L, label_lens, logit_lens, low=1, high=None):
    """Seeded logits (2 x N(0, 1)) and labels in [low, high), padded with
    -1 past each label length."""
    g = torch.Generator().manual_seed(seed)
    logits = 2 * torch.randn(B, T, V, generator=g)
    labels = torch.randint(low, high or V, (B, L), generator=g)
    label_lens = torch.tensor(label_lens, dtype=torch.int32)
    labels[torch.arange(L)[None] >= label_lens[:, None]] = -1
    return (logits, torch.tensor(logit_lens, dtype=torch.int32), labels,
            label_lens)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["conformer", "squeezeformer"])
def test_train_layer_kernel_row_offset(cuda_device, family):
    """Rows 3 and 7 with dropout 0.1 at row0 = 4 (the last 2 of a global
    batch of 6, as the second of three data-parallel ranks runs them): the
    kernel == the plain twin at row0 = 4 (output 2e-4, grads 1e-4 of their
    largest), and == the plain twin on the whole batch of 6 at row0 = 0 in
    those 2 rows, so a row draws the same masks whatever rank runs it."""
    from masr_tpu_torch.ops.cuda import conformer_layer_train as clt
    from masr_tpu_torch.ops.cuda import squeezeformer_layer_train as sqt
    from masr_tpu_torch.ops.cuda.squeezeformer_layer import \
        pack_sq_layer_params
    D, H, FF, K, T, B = 64, 2, 96, 7, 45, 6
    if family == "conformer":
        layer = ConformerEncoderLayer(D, H, FF, cnn_module_kernel=K,
                                      causal=True)
        layer.load_state_dict(seeded_state_dict(layer, seed=7))
        layer = layer.to(cuda_device)
        kernel, plain = (clt.fused_conformer_layer_train,
                         clt.fused_conformer_layer_train_plain)
        packed0 = {k: v.detach()
                   for k, v in cl.pack_layer_params(layer).items()}
    else:
        layer = _sq_layer(D, H, FF, K, True, "layer_norm", 7, cuda_device)
        kernel, plain = (sqt.fused_squeezeformer_layer_train,
                         sqt.fused_squeezeformer_layer_train_plain)
        with torch.no_grad():
            packed0 = pack_sq_layer_params(layer)
    g = torch.Generator().manual_seed(11)
    x = torch.randn(B, T, D, generator=g).to(cuda_device)
    w = torch.randn(B, T, D, generator=g).to(cuda_device)
    lens = torch.tensor([45, 40, 33, 45, 38, 29], dtype=torch.int32,
                        device=cuda_device)
    r = torch.arange(T, device=cuda_device)
    mask = ((r[None, :] // 16) <= (r[:, None] // 16))[None] & \
        (r[None, None, :] < lens[:, None, None])
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (B,), generator=g,
                          dtype=torch.int32).to(cuda_device)
    with torch.no_grad():
        posp0 = layer.self_attn.linear_pos(sinusoid_position_encoding(r, D))

    def run(fn, rows, row0):
        xx = x[rows].clone().requires_grad_(True)
        pk = {k: v.clone().requires_grad_(True) for k, v in packed0.items()}
        y = fn(xx, mask[rows], seeds[rows].contiguous(), lens[rows],
               posp0.clone(), pk, layer=2, n_head=H, ksize=K, causal=True,
               rate=0.1, att_rate=0.1, row0=row0)
        (y * w[rows]).sum().backward()
        torch.cuda.synchronize()
        return y.detach(), xx.grad, {k: v.grad for k, v in pk.items()}

    tail = slice(4, 6)
    y_k, dx_k, dw_k = run(kernel, tail, 4)
    y_p, dx_p, dw_p = run(plain, tail, 4)
    y_w, _, _ = run(plain, slice(0, 6), 0)
    y_0, _, _ = run(kernel, tail, 0)
    assert (y_k - y_p).abs().max().item() <= 2e-4
    assert (y_k - y_w[tail]).abs().max().item() <= 2e-4
    assert (y_0 - y_k).abs().max().item() > 1e-2
    for name, a, b in [("x", dx_k, dx_p)] + [(k, dw_k[k], dw_p[k])
                                            for k in dw_p]:
        assert _rel_err(a, b) <= 1e-4, (name, _rel_err(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("L,T,V", [(300, 700, 50), (1100, 2300, 24)],
                         ids=["S601", "S2201"])
def test_ctc_kernel_many_states(cuda_device, L, T, V):
    """S = 601 (three warps of 32 lanes x 8 states) and S = 2201 (past the
    register chains: the strided kernel): the card's gates."""
    batch = _ctc_batch(L, 2, T, V, L, [L, L - 37], [T, T - 40])
    _ctc_gates(cuda_device, *batch, seed=L)


@pytest.mark.cuda
def test_ctc_kernel_one_frame(cuda_device):
    """T' = 1: label lengths 0 and 1 (the only feasible ones) and a frame
    count of 0 (optax's: its loss from the rows before frame 0, 1e5 - ln 2
    for its label, its grad 0, so it stays out of the grad gate)."""
    batch = _ctc_batch(21, 3, 1, 11, 1, [0, 1, 1], [1, 1, 0])
    _, g_k = _ctc_gates(cuda_device, *batch, seed=21, rows=slice(0, 2))
    assert g_k[2].abs().max().item() == 0.0


@pytest.mark.cuda
def test_ctc_kernel_every_label_the_same(cuda_device):
    """Every label token the same, so every skip is barred; frame counts
    from the least the alignment allows (L + the L - 1 repeats) up."""
    L = 40
    batch = _ctc_batch(22, 3, 120, 30, L, [L, L, 25], [120, 2 * L - 1, 49],
                       low=7, high=8)
    _ctc_gates(cuda_device, *batch, seed=22)


@pytest.mark.cuda
def test_ctc_kernel_shortest_frames(cuda_device):
    """tlen as short as the alignment allows: L plus the number of adjacent
    repeats in each label (labels from 3 tokens, so repeats are common)."""
    L, B = 30, 4
    logits, _, labels, label_lens = _ctc_batch(23, B, 90, 20, L,
                                               [30, 24, 17, 9], [90] * B,
                                               low=1, high=4)
    tl = []
    for b in range(B):
        lab = labels[b, :int(label_lens[b])].tolist()
        tl.append(len(lab) + sum(x == y for x, y in zip(lab, lab[1:])))
    _ctc_gates(cuda_device, logits, torch.tensor(tl, dtype=torch.int32),
               labels, label_lens, seed=23)


@pytest.mark.cuda
def test_ctc_kernel_infeasible_alignment(cuda_device):
    """Sequence 1 has more labels than its frames allow: its NLL is
    optax's, 1e5 + the cost of its paths with one -1e5 step, as the plain
    twin's (rtol 1e-5), and the grad gate holds on every sequence, the
    infeasible one included (both count the -1e5 steps by class)."""
    batch = _ctc_batch(24, 3, 40, 13, 12, [12, 12, 6], [40, 8, 30])
    n_k, _ = _ctc_gates(cuda_device, *batch, seed=24)
    assert 1e5 < n_k[1] < 1.01e5 and n_k[0] < 1e4


@pytest.mark.cuda
@pytest.mark.parametrize("L,T,V", [(300, 700, 50), (1100, 2300, 24)],
                         ids=["S601", "S2201"])
def test_ctc_kernel_infeasible_many_states(cuda_device, L, T, V):
    """Three warps (S = 601) and the strided kernel (S = 2201) on a batch
    whose second sequence has L labels over L - 60 frames and whose third
    has no frame: the card's gates on every sequence but the frameless
    one, whose NLL is 1e5 - ln 2 and whose grad is 0."""
    batch = _ctc_batch(L + 1, 3, T, V, L, [L, L, L - 5], [T, L - 60, 0])
    n_k, g_k = _ctc_gates(cuda_device, *batch, seed=L + 1, rows=[0, 1])
    assert 1e5 < n_k[1] < 1.1e5
    assert abs(n_k[2].item() - (1e5 - 0.6931471805599453)) < 0.02
    assert g_k[2].abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("L,V", [(8, 5), (1000, 4), (1100, 4)],
                         ids=["S17", "S2001", "S2201"])
def test_ctc_kernel_feasibility_edge(cuda_device, L, V):
    """Two rows of the same labels drawn from two tokens (many equal
    neighbours), one over exactly as many frames as the labels and the
    blanks between equal neighbours take (a forced alignment) and one over
    a frame fewer: the kernel runs the first without classes and the
    second with them, and the card's gates hold on both (one register
    warp, S = 17; eight register warps, S = 2001; the strided kernel, S =
    2201). The forced rows' offsets follow the max over their live states
    only (csrc/ctc_loss.cu, "Live states")."""
    g = torch.Generator().manual_seed(L)
    labels = torch.randint(1, 3, (1, L), generator=g).repeat(2, 1)
    need = L + int((labels[0, 1:] == labels[0, :-1]).sum())
    logits = 2 * torch.randn(2, need + 3, V, generator=g)
    n_k, _ = _ctc_gates(cuda_device, logits,
                        torch.tensor([need, need - 1], dtype=torch.int32),
                        labels, torch.tensor([L, L], dtype=torch.int32),
                        seed=L)
    assert n_k[0] < 5e4 and 1e5 < n_k[1] < 1.1e5


def _ctc_smoke_batch():
    """chip_smoke's CTC shape: B=8, T'=299, V=4000, label lengths 5..80
    (S = 161), frames 33..299."""
    return _ctc_batch(25, 8, 299, 4000, 80, [5, 10, 15, 20, 25, 30, 40, 80],
                      [33, 90, 150, 180, 220, 250, 281, 299])


@pytest.mark.cuda
def test_ctc_kernel_batch_invariant_and_repeatable(cuda_device):
    """Each sequence's NLL and grad bits at B=1 equal its slice of the B=8
    call, and two runs of the B=8 call give the same bits."""
    from masr_tpu_torch.ops.cuda import ctc_loss as C
    logits, lens, labels, label_lens = (t.to(cuda_device)
                                        for t in _ctc_smoke_batch())
    labels = labels.int()
    wts = torch.randn(8, generator=torch.Generator().manual_seed(26)).to(
        cuda_device)
    runs = [_ctc_run(C.ctc_loss, torch.float32, logits,
                     (lens, labels, label_lens), wts) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    for b in (0, 3, 7):
        s = slice(b, b + 1)
        n1, g1, _ = _ctc_run(C.ctc_loss, torch.float32, logits[s],
                             (lens[s], labels[s], label_lens[s]), wts[s])
        assert torch.equal(n1, runs[0][0][s]), b
        assert torch.equal(g1, runs[0][1][s]), b


@pytest.mark.cuda
def test_ctc_kernel_eval_forward(cuda_device):
    """A forward without grad (the eval passes: the beta chains and the
    group tables skipped) gives the NLL bits of the forward with grad,
    one launch."""
    from masr_tpu_torch.ops.cuda import ctc_loss as C
    logits, lens, labels, label_lens = (t.to(cuda_device)
                                        for t in _ctc_smoke_batch())
    args = (lens, labels.int(), label_lens)
    wts = torch.ones(8, device=cuda_device)
    n_grad, _, _ = _ctc_run(C.ctc_loss, torch.float32, logits, args, wts)
    with torch.no_grad():
        n_eval, _, launched = _ctc_run(C.ctc_loss, torch.float32, logits,
                                       args, wts, grad=False)
    assert launched == 1
    assert torch.equal(n_eval, n_grad)


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


def _slot_args(args, s, L=None):
    """Slot s of a chunk kernel's arguments (x, pos, starts, att, cnn,
    cache_lens, wptrs, active, packed) as a B=1 call: its caches cloned;
    with L (exact positions, L rows per slot), its own window of pos from
    row 0, else the shared table at its start."""
    x, pos, starts, att, cnn, clens, wptrs, active, packed = args
    one = slice(s, s + 1)
    if L is not None:
        pos, starts = pos[s * L:(s + 1) * L], torch.zeros_like(starts[one])
    else:
        starts = starts[one]
    return (x[one], pos, starts, att[one].clone(), cnn[one].clone(),
            clens[one], wptrs[one], active[one], packed)


def _assert_batch_invariant(fn, args, kw, L):
    """Each slot's output and updated caches from a B=1 call equal bit for
    bit its slice of one call over all the slots."""
    att0, cnn0 = args[3].clone(), args[4].clone()
    with torch.no_grad():
        y = fn(*args, **kw)
        for s in range(args[0].shape[0]):
            one = _slot_args(args[:3] + (att0, cnn0) + args[5:], s, L)
            y1 = fn(*one, **kw)
            assert torch.equal(y1, y[s:s + 1]), ("out", s)
            assert torch.equal(one[3], args[3][s:s + 1]), ("att", s)
            assert torch.equal(one[4], args[4][s:s + 1]), ("cnn", s)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["exact", "table"])
@pytest.mark.parametrize("n_sub", [1, 2])
def test_chunk_layer_kernel_batch_invariant(cuda_device, n_sub, route):
    """fused_chunk_layer (CUDA) at the flagship's engine shape (B=32,
    c=16·n_sub, C=256, cache_len {0, 5, 100, 256}, four inactive slots):
    each slot's output and updated caches from a B=1 call equal bit for
    bit its slice of the B=32 call (the split of K and every sum order are
    functions of the widths alone)."""
    D, H, FF, K = 256, 4, 2048, 15
    B, c, C = 32, 16 * n_sub, 256
    L = C + c
    layer = ConformerEncoderLayer(D, H, FF, cnn_module_kernel=K, causal=True)
    layer.load_state_dict(seeded_state_dict(layer, seed=21))
    layer = layer.to(cuda_device).eval()
    g = torch.Generator().manual_seed(22 + n_sub)
    x = torch.randn(B, c, D, generator=g).to(cuda_device)
    att = (0.5 * torch.randn(B, H, C, 2 * D // H, generator=g)).to(
        cuda_device)
    cnn = (0.5 * torch.randn(B, K - 1, D, generator=g)).to(cuda_device)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=cuda_device)

    clens = [(0, 5, 100, C)[s % 4] for s in range(B)]
    offsets = i32([n + 16 * s if n else 0 for s, n in enumerate(clens)])
    with torch.no_grad():
        if route == "table":
            pos = ck.make_chunk_pos_table(layer.self_attn.linear_pos.weight,
                                          C, table_len=2048)
            starts = ck.clamp_pos_starts(offsets, 2048, L)
        else:
            rows = torch.clamp(offsets[:, None] - C
                               + torch.arange(L, device=cuda_device), min=0)
            pos = layer.self_attn.linear_pos(
                sinusoid_position_encoding(rows.reshape(-1), D))
            starts = torch.arange(B, dtype=torch.int32,
                                  device=cuda_device) * L
    args = (x, pos, starts, att, cnn, i32(clens),
            i32([(37 * s) % C for s in range(B)]),
            i32([0 if s in (3, 10, 17, 29) else 1 for s in range(B)]),
            layer.chunk_packed_params())
    _assert_batch_invariant(ck.fused_chunk_layer, args,
                            dict(n_head=H, ksize=K, n_sub=n_sub),
                            L if route == "exact" else None)


@pytest.mark.cuda
@pytest.mark.parametrize("rep", [1, 2], ids=["full_rate", "half_rate"])
@pytest.mark.parametrize("n_sub", [1, 2])
def test_chunk_layer_sq_kernel_batch_invariant(cuda_device, n_sub, rep):
    """fused_chunk_layer_sq (CUDA) at the flagship Squeezeformer's engine
    shape, full rate (c=16·n_sub, C=256) and half rate (c=8·n_sub, C=128
    on the full-resolution ring): each slot's output and updated caches
    from a B=1 call equal bit for bit its slice of the B=32 call."""
    from masr_tpu_torch.ops.cuda import chunk_layer_sq as cks
    D, H, FF, K = 256, 4, 2048, 31
    B, c, C = 32, 16 * n_sub // rep, 256 // rep
    L = C + c
    layer = _sq_layer(D, H, FF, K, True, "batch_norm", 23, cuda_device)
    g = torch.Generator().manual_seed(24 + n_sub + rep)
    x = torch.randn(B, c, D, generator=g).to(cuda_device)
    att = (0.5 * torch.randn(B, H, C * rep, 2 * D // H, generator=g)).to(
        cuda_device)
    cnn = (0.5 * torch.randn(B, K - 1, D, generator=g)).to(cuda_device)
    pos = torch.randn(B * L, D, generator=g).to(cuda_device)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=cuda_device)

    args = (x, pos, torch.arange(B, dtype=torch.int32,
                                 device=cuda_device) * L,
            att, cnn, i32([(0, 5, C // 2, C)[s % 4] for s in range(B)]),
            i32([(C - 3 - 7 * s) % C for s in range(B)]),
            i32([0 if s in (3, 10, 17, 29) else 1 for s in range(B)]),
            layer.chunk_packed_params())
    _assert_batch_invariant(cks.fused_chunk_layer_sq, args,
                            dict(n_head=H, ksize=K, conv_ln=False,
                                 n_sub=n_sub, rep=rep), L)


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
# the flagship's (configs/squeezeformer.yml) at full rate (T'=299 and 300:
# score rows unaligned and aligned to 16 bytes) and at half rate (T'=150
# with the mask's [::2, ::2] rows and columns and the lengths halved
# rounding up, as after the time reduction)
SQ_TRAIN_SHAPES = [(64, 2, 128, 7, 45, [45, 36, 0], False),
                   (256, 4, 2048, 31, 299,
                    [299, 281, 250, 220, 180, 150, 90, 33], False),
                   (256, 4, 2048, 31, 299,
                    [299, 281, 250, 220, 180, 150, 90, 33], True),
                   (256, 4, 2048, 31, 300,
                    [300, 281, 250, 220, 180, 150, 90, 33], False),
                   (256, 4, 2048, 31, 300,
                    [300, 281, 250, 220, 180, 150, 90, 33], True)]


@pytest.mark.cuda
@pytest.mark.parametrize("rates", [(0.0, 0.0), (0.1, 0.1)],
                         ids=["drop0", "drop0.1"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SQ_TRAIN_SHAPES,
                         ids=["D64T45", "D256T299", "D256T150half",
                              "D256T300", "D256T150half300"])
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


# --------------------------------------------------------------------------- #
# masked rel-pos flash attention (ops/cuda/rel_pos_attention.py)
# --------------------------------------------------------------------------- #
def _att_mask(kind, T, lens, device):
    """(B, T, T) bool mask: `full` (the broadcast expand view of the pad
    mask), `static16` (chunks of 16, every left chunk), `left4` (chunks of
    16, 4 left chunks: padded rows past them see nothing), `half_rate` (the
    [::2, ::2] view of a 2T static16 mask), `random` (30% of the pairs,
    every 7th row and key tile [32, 64) hidden, utterance 1 sees one key)."""
    from masr_tpu_torch.ops.masks import add_optional_chunk_mask, \
        make_pad_mask
    lens_t = torch.tensor(lens, device=device)
    if kind == "half_rate":
        return _att_mask("static16", 2 * T, [2 * n for n in lens],
                         device)[:, ::2, ::2]
    if kind == "random":
        g = torch.Generator().manual_seed(T)
        m = torch.rand(len(lens), T, T, generator=g) < 0.3
        m[:, ::7] = False
        m[:, :, 32:64] = False
        m[1] = False
        m[1, :, T // 2] = True
        return m.to(device)
    pad = ~make_pad_mask(lens_t, T)[:, None, :]
    chunk, left = {"full": (0, -1), "static16": (16, -1),
                   "left4": (16, 4)}[kind]
    return add_optional_chunk_mask(T, pad, False, False, -1, chunk, left)


def _att_inputs(B, H, T, d, device, seed):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, H, T, d, generator=g).to(device)
               for _ in range(3))
    p = torch.randn(H, T, d, generator=g).to(device)
    bu, bv = ((0.1 * torch.randn(H, d, generator=g)).to(device)
              for _ in range(2))
    return q, k, v, p, bu, bv


def _check_attention(args, mask):
    """Kernel vs twin on the same card: finite, max abs err <= 2e-4, rows
    with no visible key exactly 0, one launch."""
    from masr_tpu_torch.ops.cuda import rel_pos_attention as rpa
    before = rpa.rel_pos_flash_attention.launches
    got = rpa.rel_pos_flash_attention(*args, mask)
    launched = rpa.rel_pos_flash_attention.launches - before
    want = rpa.rel_pos_attention_plain(*args, mask)
    torch.cuda.synchronize()
    assert launched == 1
    assert got.shape == want.shape and torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= 2e-4, err
    empty = ~mask.any(-1)                                  # (B, T)
    assert torch.all(got.transpose(1, 2)[empty] == 0.0)
    return empty


@pytest.mark.cuda
@pytest.mark.parametrize("T,d", [(37, 32), (299, 64), (1500, 128),
                                 (3000, 64)], ids=lambda v: str(v))
@pytest.mark.parametrize("kind", ["full", "static16", "left4", "half_rate",
                                  "random"])
def test_rel_pos_attention_kernel_matches_plain(cuda_device, kind, T, d):
    """rel_pos_flash_attention (CUDA) == rel_pos_attention_plain on the same
    card over every mask kind, B=4 ragged (one utterance of 0 frames), 4
    heads, d_k 32 / 64 / 128, T' up to 3000."""
    lens = [T, T - 17, max(T // 3, 1), 0]
    mask = _att_mask(kind, T, lens, cuda_device)
    with torch.no_grad():
        empty = _check_attention(
            _att_inputs(4, 4, T, d, cuda_device, T + d), mask)
    assert empty[3].all() == (kind != "random")
    if kind == "full":
        assert mask.stride(1) == 0                    # a broadcast view
    if kind == "random" or (kind == "left4" and T > 100):
        assert empty[:3].any()


@pytest.mark.cuda
def test_rel_pos_attention_kernel_strided_views(cuda_device):
    """The module's layout (q, k, v as (B, T, D) rows viewed as heads, p a
    transposed (T, H, d_k) view, the output in q's layout) and views whose
    last axis is not unit-stride give the twin's result."""
    from masr_tpu_torch.ops.cuda import rel_pos_attention as rpa
    B, H, T, d = 3, 4, 299, 64
    g = torch.Generator().manual_seed(9)
    rows = [torch.randn(B, T, H * d, generator=g).to(cuda_device)
            for _ in range(3)]
    q, k, v = (r.view(B, T, H, d).transpose(1, 2) for r in rows)
    p = torch.randn(T, H * d, generator=g).to(cuda_device).view(
        T, H, d).transpose(0, 1)
    bu, bv = (torch.randn(H, d, generator=g).to(cuda_device) * 0.1
              for _ in range(2))
    mask = _att_mask("static16", T, [T, 200, 50], cuda_device)
    with torch.no_grad():
        _check_attention((q, k, v, p, bu, bv), mask)
        out = rpa.rel_pos_flash_attention(q, k, v, p, bu, bv, mask)
        assert out.stride() == q.stride()
        wide = torch.randn(B, H, T, 2 * d, generator=g).to(cuda_device)
        _check_attention((wide[..., ::2], k, wide[..., 1::2], p, bu, bv),
                         mask)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("T", [37, 64, 65, 299, 1500])
def test_rel_pos_attention_tiles(cuda_device, T, d):
    """The tensor-core kernel around its 64-row / 64-key tiles: T' below,
    at and one past a tile, ragged, long; d_k 32, 64, 128; static-16 mask,
    B=4 with an utterance of 0 frames (every tile hidden) and utterance 1's
    first 64 query rows hidden (a block of hidden tiles). The pre-pass's
    map equals mask_tile_map_plain; the output equals the twin within
    2e-4, rows with no visible key exactly 0."""
    from masr_tpu_torch.ops.cuda import rel_pos_attention as rpa
    lens = [T, T - 17, max(T // 3, 1), 0]
    mask = _att_mask("static16", T, lens, cuda_device).clone()
    mask[1, :64] = False
    args = _att_inputs(4, 4, T, d, cuda_device, 3 * T + d)
    nt = -(-T // 64)
    tmap = torch.full((4, nt, nt), 7, dtype=torch.uint8, device=cuda_device)
    with torch.no_grad():
        empty = _check_attention(args, mask)
        rpa.rel_pos_flash_attention(*args, mask, tile_map_out=tmap)
    torch.cuda.synchronize()
    assert torch.equal(tmap, rpa.mask_tile_map_plain(mask))
    assert (tmap[3] == rpa.HIDDEN).all() and (tmap[1, 0] == rpa.HIDDEN).all()
    assert empty[3].all() and empty[1, :min(T, 64)].all()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["full", "left4", "half_rate", "random"])
def test_rel_pos_attention_tile_map_kinds(cuda_device, kind):
    """The pre-pass's map equals the plain map over every mask kind at
    T'=299, broadcast and [::2, ::2] views included."""
    from masr_tpu_torch.ops.cuda import rel_pos_attention as rpa
    T = 299
    mask = _att_mask(kind, T, [T, T - 17, 99, 0], cuda_device)
    args = _att_inputs(4, 4, T, 64, cuda_device, 5)
    tmap = torch.empty(4, 5, 5, dtype=torch.uint8, device=cuda_device)
    with torch.no_grad():
        rpa.rel_pos_flash_attention(*args, mask, tile_map_out=tmap)
    torch.cuda.synchronize()
    assert torch.equal(tmap, rpa.mask_tile_map_plain(mask))


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["conformer", "squeezeformer"])
def test_static_chunk_flagship_launches(cuda_device, family):
    """A static-chunk flagship (static_chunk_size 16, no dynamic chunk; 12
    blocks, seeded weights): one encoder call launches the flash attention
    12 times and no full-context layer kernel; its output equals the same
    model's on the CPU (the twins) within 1e-4."""
    from masr_tpu_torch.models.registry import build_model
    from masr_tpu_torch.ops.cuda import rel_pos_attention as rpa
    from masr_tpu_torch.ops.cuda import squeezeformer_layer as sq
    if family == "conformer":
        enc, streaming = dict(output_size=256, attention_heads=4,
                              linear_units=2048, num_blocks=12,
                              cnn_module_kernel=15,
                              use_dynamic_chunk=False), True
    else:
        enc, streaming = dict(encoder_dim=256, output_size=256,
                              attention_heads=4, num_blocks=12, reduce_idx=5,
                              recover_idx=11, feed_forward_expansion_factor=8,
                              cnn_module_kernel=31), False
    model = build_model(family, 80, 100, streaming=streaming,
                        encoder_conf=dict(enc, static_chunk_size=16))
    model.load_state_dict(seeded_state_dict(model, seed=3))
    model = model.eval()
    g = torch.Generator().manual_seed(4)
    speech = torch.randn(2, 601, 80, generator=g)
    lens = torch.tensor([601, 400])
    with torch.no_grad():
        want, want_lens = model.get_encoder_out(speech, lens)
        model = model.to(cuda_device)
        before = (rpa.rel_pos_flash_attention.launches,
                  cl.fused_conformer_layer.launches,
                  sq.fused_squeezeformer_layer.launches)
        got, got_lens = model.get_encoder_out(speech.to(cuda_device),
                                              lens.to(cuda_device))
        torch.cuda.synchronize()
    assert (rpa.rel_pos_flash_attention.launches - before[0],
            cl.fused_conformer_layer.launches - before[1],
            sq.fused_squeezeformer_layer.launches - before[2]) == (12, 0, 0)
    assert torch.equal(got_lens.cpu(), want_lens)
    assert torch.isfinite(got).all()
    for b, n in enumerate(want_lens.tolist()):
        assert (got[b, :n].cpu() - want[b, :n]).abs().max().item() <= 1e-4


# --------------------------------------------------------------------------- #
# rows 1 and 6 on the tensor cores: products through gemm_sk (the serving
# tensor-core pack, K split by full_plan(K)), the attention through the flash
# kernel with a key-length mask
# --------------------------------------------------------------------------- #
def _full_lens(T):
    """B = 8 lengths: T' and 0, the edges of the flash kernel's 64-key tiles
    (64, 63, 128, 129) and a few more."""
    return [T, 0, 250, 129, 128, 64, 63, 1]


def _check_full_layer(fn, plain, x, lens, pos_p, packed, kw):
    """fn (CUDA) == plain on valid rows within 2e-4, finite everywhere, one
    launch per call; each utterance's B=1 call gives the bits of its slice
    of the B=8 call."""
    before = fn.launches
    got = fn(x, lens, pos_p, packed, **kw)
    assert fn.launches == before + 1
    want = plain(x, lens, pos_p, packed, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    for b, n in enumerate(lens.tolist()):
        err = (got[b, :n] - want[b, :n]).abs().max().item() if n else 0.0
        assert err <= 2e-4, (b, n, err)
        before = fn.launches
        one = fn(x[b:b + 1], lens[b:b + 1], pos_p, packed, **kw)
        assert fn.launches == before + 1
        assert torch.equal(one[0], got[b]), b


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [8, 4, 2], ids=lambda h: f"dk{256 // h}")
@pytest.mark.parametrize("T", [299, 300])
def test_conformer_layer_tc_kernel(cuda_device, T, heads):
    """Row 1 at the flagship's widths (D=256, FFN 2048, conv 15), d_k 32 /
    64 / 128, T' 299 (rows of 3D floats not a multiple of 16 bytes apart
    per utterance) and 300, B=8 with lengths 0, T' and the key tiles'
    edges: kernel vs plain 2e-4 on valid rows, one launch per call, and
    each utterance alone (B=1) gives the bits of its slice of the batch."""
    layer = ConformerEncoderLayer(256, heads, 2048, cnn_module_kernel=15,
                                  causal=True)
    layer.load_state_dict(seeded_state_dict(layer, seed=T + heads))
    layer = layer.to(cuda_device).eval()
    g = torch.Generator().manual_seed(T + 2)
    x = torch.randn(8, T, 256, generator=g).to(cuda_device)
    lens = torch.tensor(_full_lens(T), dtype=torch.int32, device=cuda_device)
    with torch.no_grad():
        pos_p = layer.self_attn.linear_pos(sinusoid_position_encoding(
            torch.arange(T, device=cuda_device), 256))
        _check_full_layer(cl.fused_conformer_layer,
                          cl.fused_conformer_layer_plain, x, lens, pos_p,
                          layer.chunk_packed_params(),
                          dict(n_head=heads, ksize=15, causal=True))


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [8, 4, 2], ids=lambda h: f"dk{256 // h}")
@pytest.mark.parametrize("T", [299, 300, 150], ids=["full299", "full300",
                                                    "half150"])
@pytest.mark.parametrize("conv_norm", ["batch_norm", "layer_norm"])
def test_squeezeformer_layer_tc_kernel(cuda_device, conv_norm, T, heads):
    """Row 6 at the flagship's widths (D=256, FFN 2048, conv 31), both conv
    norms, full rate (T' 299, 300) and half rate (T' 150, the lengths
    halved rounding up), d_k 32 / 64 / 128: kernel vs plain 2e-4 on valid
    rows, one launch per call, B=1 bits == the B=8 slice."""
    from masr_tpu_torch.ops.cuda import squeezeformer_layer as sq
    layer = _sq_layer(256, heads, 2048, 31, True, conv_norm, T + heads,
                      cuda_device)
    lens = _full_lens(299 if T == 150 else T)
    if T == 150:
        lens = [(n + 1) // 2 for n in lens]
    g = torch.Generator().manual_seed(T + 3)
    x = torch.randn(8, T, 256, generator=g).to(cuda_device)
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    with torch.no_grad():
        pos_p = layer.self_attn.linear_pos(sinusoid_position_encoding(
            torch.arange(T, device=cuda_device), 256))
        _check_full_layer(sq.fused_squeezeformer_layer,
                          sq.fused_squeezeformer_layer_plain, x, lens, pos_p,
                          layer.chunk_packed_params(),
                          dict(n_head=heads, ksize=31, causal=True,
                               conv_ln=conv_norm == "layer_norm"))


def _peaky_probs(B, T, V, seed):
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn(B, T, V, generator=g)
    peaks = torch.randint(0, V, (B, T), generator=g)
    logits.scatter_add_(2, peaks[..., None], torch.full((B, T, 1), 4.0))
    return torch.softmax(logits, dim=-1)


@pytest.mark.cuda
@pytest.mark.parametrize("lm", [False, True], ids=["no_lm", "bigram"])
@pytest.mark.parametrize("V", [12, 4000])
def test_device_beam_card_equals_cpu(cuda_device, V, lm):
    """The device beam (decoders/device_beam.py, PyTorch ops on the probs'
    device) at beam 10 on random peaky probs, B=4 ragged: on the card the
    same texts as its CPU run, scores within 1e-4; the state stays on the
    card (the outputs are CUDA tensors)."""
    from masr_tpu_torch.decoders.device_beam import (ctc_beam_search,
                                                     decode_batch_device)
    vocab = ["<blank>"] + [chr(0x4E00 + i) for i in range(V - 1)]
    probs = _peaky_probs(4, 60, V, V)
    lens = torch.tensor([60, 41, 60, 7])
    table = None
    if lm:
        g = torch.Generator().manual_seed(1)
        table = -3.0 * torch.rand(V + 1, V, generator=g)
    kw = dict(beam_size=10, cutoff_top_n=40, alpha=0.8, beta=0.5)
    want = decode_batch_device(probs, lens, vocab, lm_table=table, **kw)
    got = decode_batch_device(probs.to(cuda_device), lens, vocab,
                              lm_table=None if table is None
                              else table.to(cuda_device), **kw)
    assert [t for _, t in got] == [t for _, t in want]
    for (s, _), (ws, _) in zip(got, want):
        assert abs(s - ws) <= 1e-4
    tok, _, _ = ctc_beam_search(probs.to(cuda_device), lens, beam_size=10,
                                cutoff_top_n=40)
    assert tok.is_cuda


@pytest.mark.cuda
def test_device_beam_stream_card_equals_cpu(cuda_device):
    """make_stream_decode_fn chunk by chunk (16 frames, some slots idle):
    the card's best beams equal the CPU's after every chunk."""
    from masr_tpu_torch.decoders.device_beam import make_stream_decode_fn
    probs = _peaky_probs(3, 48, 300, 5)
    fns = {d: make_stream_decode_fn(beam_size=10, cutoff_top_n=40,
                                    max_len=64, device=d)
           for d in ("cpu", cuda_device)}
    states = {d: fns[d][0](3) for d in fns}
    for i in range(0, 48, 16):
        fv = torch.ones(3, 16, dtype=torch.bool)
        fv[1] = i < 16
        out = {}
        for d, (_, dec) in fns.items():
            states[d], out[d] = dec(states[d], probs[:, i:i + 16].to(d),
                                    fv.to(d))
        (tok, ln, sc), (ctok, cln, csc) = out[cuda_device], out["cpu"]
        assert torch.equal(tok.cpu(), ctok) and torch.equal(ln.cpu(), cln)
        assert (sc.cpu() - csc).abs().max() <= 1e-4


@pytest.mark.cuda
def test_device_beam_stream_class_on_the_card(cuda_device):
    """DeviceBeamStream with no device given: its state lives on the card,
    fed CUDA probs it stays there, and its best beams equal a CPU stream's
    fed the same probs (scores within 1e-4); CPU probs fed to it raise."""
    from masr_tpu_torch.decoders.device_beam import DeviceBeamStream
    probs = _peaky_probs(2, 40, 300, 7)
    card = DeviceBeamStream(batch=2, beam_size=10, cutoff_top_n=40,
                            max_len=64)
    host = DeviceBeamStream(batch=2, beam_size=10, cutoff_top_n=40,
                            max_len=64, device="cpu")
    for i in range(0, 40, 8):
        card.feed(probs[:, i:i + 8].to(cuda_device))
        host.feed(probs[:, i:i + 8])
        assert all(v.is_cuda for v in card.state.values())
    for (ids, s), (want, ws) in zip(card.best(), host.best()):
        assert ids == want and abs(s - ws) <= 1e-4
    with pytest.raises(ValueError):
        card.feed(probs[:, :8])


# --------------------------------------------------------------------------- #
# the bf16 modes of rows 1, 2 and 5 (masr_tpu's compute dtype bf16)
# --------------------------------------------------------------------------- #
def _assert_bf16_close(name, got, want):
    """Kernel vs twin in the bf16 mode. Both round the same operands to bf16
    at the same points and sum in f32, in other orders (and the kernels'
    flash and chunk attentions round the unnormalised probabilities of a
    key tile, the twins the normalised ones). One bf16 rounding is 2^-8 of
    a value; a different f32 sum flips a rounding here and there, which
    moves an output by a rounding or two. Allowed: a max abs error of 8
    roundings of the largest output, and a mean abs error of one rounding
    of the mean output magnitude."""
    assert got.dtype == want.dtype == torch.bfloat16, (name, got.dtype)
    got, want = got.float(), want.float()
    err = (got - want).abs()
    top = max(1.0, want.abs().max().item())
    mean = max(2 ** -4, want.abs().mean().item())
    assert err.max().item() <= 8 * 2 ** -8 * top, (name, err.max().item())
    assert err.mean().item() <= 2 ** -8 * mean, (name, err.mean().item())


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"D{s[0]}T{s[4]}")
def test_conformer_layer_bf16_kernel_matches_plain(cuda_device, shape,
                                                   causal):
    """Row 1's bf16 mode: fused_conformer_layer on bf16 x, pos_p and a bf16
    pack (the card's bf16 kernel) == the bf16 twin on the same card, valid
    rows (_assert_bf16_close), output bf16 and finite, one launch."""
    D, H, FF, K, T, lens = shape
    layer = ConformerEncoderLayer(D, H, FF, cnn_module_kernel=K,
                                  causal=causal)
    layer.load_state_dict(seeded_state_dict(layer, seed=D + T))
    layer = layer.to(cuda_device)
    g = torch.Generator().manual_seed(T)
    x = torch.randn(len(lens), T, D, generator=g).to(cuda_device,
                                                      torch.bfloat16)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    with torch.no_grad():
        pos_p = layer.self_attn.linear_pos(sinusoid_position_encoding(
            torch.arange(T, device=cuda_device), D).to(torch.bfloat16))
        packed = cl.pack_layer_params(layer, torch.bfloat16)
        before = cl.fused_conformer_layer.launches
        got = cl.fused_conformer_layer(x, lens_t, pos_p, packed, n_head=H,
                                       ksize=K, causal=causal)
        want = cl.fused_conformer_layer_plain(x, lens_t, pos_p, packed,
                                              n_head=H, ksize=K,
                                              causal=causal)
    torch.cuda.synchronize()
    assert cl.fused_conformer_layer.launches == before + 1
    assert torch.isfinite(got.float()).all()
    for b, n in enumerate(lens):
        if n:
            _assert_bf16_close((b, n), got[b, :n], want[b, :n])


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["exact", "table"])
@pytest.mark.parametrize("n_sub", [1, 2])
@pytest.mark.parametrize("shape", CHUNK_SHAPES, ids=lambda s: f"D{s[0]}C{s[5]}")
def test_chunk_layer_bf16_kernel_matches_plain(cuda_device, shape, n_sub,
                                               route):
    """Row 2's bf16 mode: bf16 x, positions, ring and cnn cache, a bf16
    pack: outputs and updated caches == the bf16 twin's on the same card
    (_assert_bf16_close), over slots mixing cache_len {0, partial, full},
    write pointers and offsets; inactive slots' caches stay bitwise
    unchanged; one launch."""
    D, H, FF, K, c, C = shape
    c *= n_sub
    d_k, L = D // H, C + c
    bf = torch.bfloat16
    layer = ConformerEncoderLayer(D, H, FF, cnn_module_kernel=K, causal=True)
    layer.load_state_dict(seeded_state_dict(layer, seed=D + C + c))
    layer = layer.to(cuda_device)
    g = torch.Generator().manual_seed(c + C)
    x = torch.randn(6, c, D, generator=g).to(cuda_device, bf)
    att = (0.5 * torch.randn(6, H, C, 2 * d_k, generator=g)).to(cuda_device,
                                                                bf)
    cnn = (0.5 * torch.randn(6, K - 1, D, generator=g)).to(cuda_device, bf)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=cuda_device)

    clens = i32([0, 5, min(100, C), C, C, 3])
    wptrs = i32([0, 3, 7 % C, C - 1, 11 % C, 0])
    active = i32([1, 1, 1, 1, 0, 0])
    offsets = [0, 5, 100, 400, 250, 3]
    with torch.no_grad():
        if route == "table":
            pos = ck.make_chunk_pos_table(layer.self_attn.linear_pos.weight,
                                          C, table_len=1024, dtype=bf)
            starts = ck.clamp_pos_starts(i32(offsets), 1024, L)
        else:
            rows = torch.clamp(i32(offsets)[:, None] - C
                               + torch.arange(L, device=cuda_device), min=0)
            pos = layer.self_attn.linear_pos(
                sinusoid_position_encoding(rows.reshape(-1), D).to(bf))
            starts = torch.arange(6, dtype=torch.int32,
                                  device=cuda_device) * L
        packed = cl.pack_layer_params(layer, bf)
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
    assert torch.isfinite(got.float()).all()
    for name, k_t, p_t in (("out", got, want), ("att", a_k[:4], a_p[:4]),
                           ("cnn", n_k[:4], n_p[:4])):
        _assert_bf16_close(name, k_t, p_t)
    assert torch.equal(a_k[4:], att[4:]) and torch.equal(n_k[4:], cnn[4:])
    assert not torch.equal(a_k[:4], att[:4])


@pytest.mark.cuda
@pytest.mark.parametrize("T,d", [(37, 32), (299, 64), (1500, 128)],
                         ids=lambda v: str(v))
@pytest.mark.parametrize("kind", ["full", "static16", "left4", "random"])
def test_rel_pos_attention_bf16_kernel_matches_plain(cuda_device, kind, T, d):
    """Row 5's bf16 mode: bf16 q, k, v, p and biases (the card's bf16
    kernel) == the bf16 twin on the same card (_assert_bf16_close), bf16
    output, rows with no visible key exactly 0, one launch."""
    from masr_tpu_torch.ops.cuda import rel_pos_attention as rpa
    lens = [T, T - 17, max(T // 3, 1), 0]
    mask = _att_mask(kind, T, lens, cuda_device)
    args = tuple(t.to(torch.bfloat16)
                 for t in _att_inputs(4, 4, T, d, cuda_device, T + d))
    with torch.no_grad():
        before = rpa.rel_pos_flash_attention.launches
        got = rpa.rel_pos_flash_attention(*args, mask)
        launched = rpa.rel_pos_flash_attention.launches - before
        want = rpa.rel_pos_attention_plain(*args, mask)
    torch.cuda.synchronize()
    assert launched == 1 and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    _assert_bf16_close(kind, got, want)
    empty = ~mask.any(-1)
    assert torch.all(got.transpose(1, 2)[empty] == 0.0)


def _check_rel_pos_bf16(args, mask):
    """Row 5's bf16 kernel vs its bf16 twin on the same card: one launch
    (and one bf16 launch), bf16 output of q's shape, finite,
    _assert_bf16_close, rows with no visible key exactly 0. → the
    kernel's output."""
    from masr_tpu_torch.ops.cuda import rel_pos_attention as rpa
    f = rpa.rel_pos_flash_attention
    with torch.no_grad():
        before, before16 = f.launches, f.bf16_launches
        got = f(*args, mask)
        launched = (f.launches - before, f.bf16_launches - before16)
        want = rpa.rel_pos_attention_plain(*args, mask)
    torch.cuda.synchronize()
    assert launched == (1, 1) and got.shape == want.shape
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    _assert_bf16_close(f"{tuple(args[0].shape)}", got, want)
    empty = ~mask.any(-1)
    assert torch.all(got.transpose(1, 2)[empty] == 0.0)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("T,d", [(64, 64), (65, 32), (150, 128), (1499, 64),
                                 (1500, 32), (1500, 128)],
                         ids=lambda v: str(v))
def test_rel_pos_attention_bf16_kernel_shapes(cuda_device, T, d):
    """The bf16 kernel (flash_wgmma.cuh) at T' on and off a multiple of 64
    (the last key tile's rows past T' land as TMA's zeros), d_k 32 (one
    64-column block, half of it zeros), 64 and 128 (two blocks), under the
    static-16 mask of B=4 utterances of T', 0, T' / 2 and 1 frames."""
    mask = _att_mask("static16", T, [T, 0, T // 2, 1], cuda_device)
    args = tuple(t.to(torch.bfloat16)
                 for t in _att_inputs(4, 4, T, d, cuda_device, 3 * T + d))
    got = _check_rel_pos_bf16(args, mask)
    assert torch.all(got[1] == 0.0)


@pytest.mark.cuda
def test_rel_pos_attention_bf16_kernel_strided_views(cuda_device):
    """The bf16 kernel on the module's layout: q, k, v (B, T, D) rows
    viewed as heads, p a transposed (T, H, d_k) view, the output in q's
    layout; views whose last axis is not unit-stride; and a d_k of 36,
    whose heads start 72 bytes apart, which TMA cannot read as it lies
    (the wrapper copies it to 16-byte rows first)."""
    from masr_tpu_torch.ops.cuda import rel_pos_attention as rpa
    bf = torch.bfloat16
    g = torch.Generator().manual_seed(19)
    for B, H, T, d in ((3, 4, 299, 64), (2, 4, 130, 36)):
        rows = [torch.randn(B, T, H * d, generator=g).to(cuda_device, bf)
                for _ in range(3)]
        q, k, v = (r.view(B, T, H, d).transpose(1, 2) for r in rows)
        p = torch.randn(T, H * d, generator=g).to(cuda_device, bf).view(
            T, H, d).transpose(0, 1)
        bu, bv = ((0.1 * torch.randn(H, d, generator=g)).to(cuda_device, bf)
                  for _ in range(2))
        mask = _att_mask("static16", T, [T, 100, 50][:B], cuda_device)
        assert rpa.tma_ready(k) == (d % 8 == 0)
        out = _check_rel_pos_bf16((q, k, v, p, bu, bv), mask)
        assert out.stride() == q.stride()
        wide = torch.randn(B, H, T, 2 * d, generator=g).to(cuda_device, bf)
        _check_rel_pos_bf16((wide[..., ::2], k, wide[..., 1::2], p, bu, bv),
                            mask)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [(32, 16), (1, 16), (8, 299), (3, 5)],
                         ids=lambda r: f"{r[0]}x{r[1]}")
def test_serving_product_bf16_kernel_matches_plain(cuda_device, rows):
    """The subsampling's bf16 product (csrc/chunk_layer.cu
    masr_serving_product_bf16) at the flagship's K = 4864, N = 256, at the
    engine's 32 windows, one window, 8 utterances and a ragged 15 rows:
    against its twin within _assert_bf16_close, and every block's bits
    from a call of its own rows equal to its rows of the whole call (the
    split fixed by N and K, never the rows)."""
    K, N = 256 * 19, 256
    g = torch.Generator().manual_seed(7)
    w = (torch.randn(K, N, generator=g) / K ** 0.5).to(cuda_device,
                                                       torch.bfloat16)
    x = torch.relu(torch.randn(*rows, K, generator=g)).to(cuda_device,
                                                          torch.bfloat16)
    with torch.no_grad():
        before = ck.serving_product.launches
        got = ck.serving_product(x, w)
        assert ck.serving_product.launches - before == 1
        want = ck.serving_product_plain(x, w)
        alone = [ck.serving_product(x[b:b + 1], w) for b in range(rows[0])]
    torch.cuda.synchronize()
    assert got.shape == (*rows, N) and got.dtype == torch.bfloat16
    _assert_bf16_close(f"serving product {rows}", got, want)
    for b, one in enumerate(alone):
        assert torch.equal(one, got[b:b + 1]), b


@pytest.mark.cuda
def test_bf16_kernels_refuse_mixed_dtypes(cuda_device):
    """A bf16 x with an f32 pack, or f16 operands, raise on the card: no
    silent upcast and no f32 fallback."""
    from masr_tpu_torch.ops.cuda import rel_pos_attention as rpa
    layer = ConformerEncoderLayer(64, 2, 96, cnn_module_kernel=7,
                                  causal=True).to(cuda_device)
    x = torch.randn(2, 8, 64, device=cuda_device, dtype=torch.bfloat16)
    lens = torch.tensor([8, 5], dtype=torch.int32, device=cuda_device)
    pos_p = torch.randn(8, 64, device=cuda_device, dtype=torch.bfloat16)
    with torch.no_grad(), pytest.raises(ValueError, match="mixed"):
        cl.fused_conformer_layer(x, lens, pos_p, cl.pack_layer_params(layer),
                                 n_head=2, ksize=7, causal=True)
    q = torch.randn(1, 2, 8, 32, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="f32 or bf16"):
        rpa.rel_pos_flash_attention(q, q, q, q[0], q[0, :, 0], q[0, :, 0],
                                    torch.ones(1, 8, 8, dtype=torch.bool,
                                               device=cuda_device))


# --------------------------------------------------------------------------- #
# the bf16 modes of rows 6 and 8 (the Squeezeformer's layer kernels)
# --------------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("conv_norm", ["batch_norm", "layer_norm"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SQ_SHAPES, ids=lambda s: f"D{s[0]}T{s[4]}")
def test_squeezeformer_layer_bf16_kernel_matches_plain(cuda_device, shape,
                                                       causal, conv_norm):
    """Row 6's bf16 mode: fused_squeezeformer_layer on bf16 x and pos_p and
    the bf16 pack (unfolded adaptive scales, bf16 products) == the bf16
    twin on the same card, valid rows (_assert_bf16_close), at the test
    widths and the flagship's full and half rate (phase 14's shapes);
    output bf16 and finite; one launch, counted as a bf16 launch."""
    from masr_tpu_torch.ops.cuda import squeezeformer_layer as sq
    D, H, FF, K, T, lens = shape
    bf = torch.bfloat16
    layer = _sq_layer(D, H, FF, K, causal, conv_norm, D + T, cuda_device)
    g = torch.Generator().manual_seed(T + 1)
    x = torch.randn(len(lens), T, D, generator=g).to(cuda_device, bf)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    kw = dict(n_head=H, ksize=K, causal=causal,
              conv_ln=conv_norm == "layer_norm")
    with torch.no_grad():
        pos_p = layer.self_attn.linear_pos(sinusoid_position_encoding(
            torch.arange(T, device=cuda_device), D).to(bf))
        packed = layer.chunk_packed_params(bf)
        assert packed["ada"].shape == (4, 2, D)
        before = (sq.fused_squeezeformer_layer.launches,
                  sq.fused_squeezeformer_layer.bf16_launches)
        got = sq.fused_squeezeformer_layer(x, lens_t, pos_p, packed, **kw)
        want = sq.fused_squeezeformer_layer_plain(x, lens_t, pos_p, packed,
                                                  **kw)
    torch.cuda.synchronize()
    assert (sq.fused_squeezeformer_layer.launches,
            sq.fused_squeezeformer_layer.bf16_launches) == (
                before[0] + 1, before[1] + 1)
    assert torch.isfinite(got.float()).all()
    for b, n in enumerate(lens):
        if n:
            _assert_bf16_close((b, n), got[b, :n], want[b, :n])


@pytest.mark.cuda
@pytest.mark.parametrize("rep", [1, 2], ids=["full_rate", "half_rate"])
@pytest.mark.parametrize("n_sub", [1, 2])
@pytest.mark.parametrize("shape", SQ_CHUNK_SHAPES,
                         ids=lambda s: f"D{s[0]}C{s[5]}")
def test_chunk_layer_sq_bf16_kernel_matches_plain(cuda_device, shape, n_sub,
                                                  rep):
    """Row 8's bf16 mode: bf16 x, positions, ring and cnn cache and the bf16
    pack, at full rate and at half rate on the full-resolution ring:
    outputs and updated caches == the bf16 twin's on the same card
    (_assert_bf16_close), over slots mixing cache_len {0, partial, full}
    and wrapping write pointers; the two copies of every half-rate ring row
    are bitwise equal; inactive slots' caches stay bitwise unchanged; one
    launch, counted as a bf16 launch."""
    from masr_tpu_torch.ops.cuda import chunk_layer_sq as cks
    D, H, FF, K, c, C = shape
    c, C = c * n_sub // rep, C // rep
    d_k, L = D // H, C + c
    bf = torch.bfloat16
    layer = _sq_layer(D, H, FF, K, True, "batch_norm", D + C + c,
                      cuda_device)
    g = torch.Generator().manual_seed(c + C)
    x = torch.randn(6, c, D, generator=g).to(cuda_device, bf)
    att = (0.5 * torch.randn(6, H, C, 2 * d_k, generator=g)).to(
        cuda_device, bf).repeat_interleave(rep, dim=2)
    cnn = (0.5 * torch.randn(6, K - 1, D, generator=g)).to(cuda_device, bf)

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
            sinusoid_position_encoding(rows.reshape(-1), D).to(bf))
        starts = torch.arange(6, dtype=torch.int32, device=cuda_device) * L
        packed = layer.chunk_packed_params(bf)
        res = {}
        for name, fn in (("kernel", cks.fused_chunk_layer_sq),
                         ("plain", cks.fused_chunk_layer_sq_plain)):
            a, n = att.clone(), cnn.clone()
            before = cks.fused_chunk_layer_sq.bf16_launches
            out = fn(x, pos, starts, a, n, clens, wptrs, active, packed,
                     n_head=H, ksize=K, conv_ln=False, n_sub=n_sub, rep=rep)
            res[name] = (out, a, n,
                         cks.fused_chunk_layer_sq.bf16_launches - before)
    torch.cuda.synchronize()
    (got, a_k, n_k, launched), (want, a_p, n_p, _) = (res["kernel"],
                                                      res["plain"])
    assert launched == 1
    assert torch.isfinite(got.float()).all()
    for name, k_t, p_t in (("out", got, want), ("att", a_k[:4], a_p[:4]),
                           ("cnn", n_k[:4], n_p[:4])):
        _assert_bf16_close(name, k_t, p_t)
    if rep == 2:
        assert torch.equal(a_k[:, :, 0::2], a_k[:, :, 1::2])
    assert torch.equal(a_k[4:], att[4:]) and torch.equal(n_k[4:], cnn[4:])
    assert not torch.equal(a_k[:4], att[:4])


@pytest.mark.cuda
@pytest.mark.parametrize("rep", [1, 2], ids=["full_rate", "half_rate"])
def test_chunk_layer_sq_bf16_kernel_batch_invariant(cuda_device, rep):
    """Row 8's bf16 mode at the flagship Squeezeformer's engine shape
    (B=32, c=16 or 8, C=256 or 128 on the full-resolution ring): each
    slot's output and updated bf16 caches from a B=1 call equal bit for
    bit its slice of the B=32 call, as in f32."""
    from masr_tpu_torch.ops.cuda import chunk_layer_sq as cks
    D, H, FF, K = 256, 4, 2048, 31
    B, c, C = 32, 16 // rep, 256 // rep
    L, bf = C + c, torch.bfloat16
    layer = _sq_layer(D, H, FF, K, True, "batch_norm", 25, cuda_device)
    g = torch.Generator().manual_seed(26 + rep)
    x = torch.randn(B, c, D, generator=g).to(cuda_device, bf)
    att = (0.5 * torch.randn(B, H, C, 2 * D // H, generator=g)).to(
        cuda_device, bf).repeat_interleave(rep, dim=2)
    cnn = (0.5 * torch.randn(B, K - 1, D, generator=g)).to(cuda_device, bf)
    pos = torch.randn(B * L, D, generator=g).to(cuda_device, bf)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=cuda_device)

    args = (x, pos, torch.arange(B, dtype=torch.int32,
                                 device=cuda_device) * L,
            att, cnn, i32([(0, 5, C // 2, C)[s % 4] for s in range(B)]),
            i32([(C - 3 - 7 * s) % C for s in range(B)]),
            i32([0 if s in (3, 10, 17, 29) else 1 for s in range(B)]),
            layer.chunk_packed_params(bf))
    _assert_batch_invariant(cks.fused_chunk_layer_sq, args,
                            dict(n_head=H, ksize=K, conv_ln=False,
                                 rep=rep), L)


@pytest.mark.cuda
def test_sq_bf16_kernels_refuse_mixed_dtypes(cuda_device):
    """Rows 6 and 8 on the card: a bf16 x with the f32 pack, or an f32
    cache under a bf16 x, raise (no silent upcast, no f32 fallback)."""
    from masr_tpu_torch.ops.cuda import chunk_layer_sq as cks
    from masr_tpu_torch.ops.cuda import squeezeformer_layer as sq
    layer = _sq_layer(64, 2, 128, 7, True, "batch_norm", 3, cuda_device)
    bf = torch.bfloat16
    x = torch.randn(2, 8, 64, device=cuda_device, dtype=bf)
    lens = torch.tensor([8, 5], dtype=torch.int32, device=cuda_device)
    with torch.no_grad(), pytest.raises(ValueError, match="mixed"):
        sq.fused_squeezeformer_layer(
            x, lens, torch.randn(8, 64, device=cuda_device, dtype=bf),
            layer.chunk_packed_params(), n_head=2, ksize=7, causal=True,
            conv_ln=False)
    i32 = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    with torch.no_grad(), pytest.raises(ValueError, match="mixed"):
        cks.fused_chunk_layer_sq(
            x, torch.randn(80, 64, device=cuda_device, dtype=bf), i32,
            torch.zeros(2, 2, 32, 64, device=cuda_device),
            torch.zeros(2, 6, 64, device=cuda_device, dtype=bf), i32, i32,
            i32 + 1, layer.chunk_packed_params(bf), n_head=2, ksize=7,
            conv_ln=False)


# --------------------------------------------------------------------------- #
# the bf16 modes of rows 3 and 7 (the training layers, masr_tpu's
# enable_amp)
# --------------------------------------------------------------------------- #
def _assert_bf16_train_close(name, got, want):
    """A bf16 training layer, kernel vs twin: both round the same operands
    and rows to bf16 at the same points and sum in f32 in other orders, so
    a rounding flips here and there (_assert_bf16_close). Each output and
    grad is measured against its own largest value (a grad may be far
    below 1): a max abs error of 8 roundings of max |want| and a mean abs
    error of one rounding of mean |want|."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    top = max(want.abs().max().item(), 1e-30)
    mean = max(want.abs().mean().item(), 1e-30)
    assert err.max().item() <= 8 * 2 ** -8 * top, (name, err.max().item(),
                                                   top)
    assert err.mean().item() <= 2 ** -8 * mean, (name, err.mean().item(),
                                                 mean)


def _train_bf16_run(fn, counter, x, mask, seeds, lens, posp, packed, w, kw):
    """fn on bf16 clones with grad; (y * w).sum() backward → (y, dx,
    dposp, {key: grad}, launches, bf16 launches)."""
    xx = x.clone().requires_grad_(True)
    pp = posp.clone().requires_grad_(True)
    pk = {k: v.detach().clone().requires_grad_(True)
          for k, v in packed.items()}
    before = (counter.launches, counter.bf16_launches)
    y = fn(xx, mask, seeds, lens, pp, pk, **kw)
    (y.float() * w).sum().backward()
    torch.cuda.synchronize()
    return (y.detach(), xx.grad, pp.grad, {k: v.grad for k, v in pk.items()},
            counter.launches - before[0], counter.bf16_launches - before[1])


def _check_train_bf16(kernel, plain, args, kw):
    (y_k, dx_k, dp_k, dw_k, n_k, b_k) = _train_bf16_run(kernel, kernel,
                                                        *args, kw)
    (y_p, dx_p, dp_p, dw_p, _, _) = _train_bf16_run(plain, kernel, *args, kw)
    assert n_k == 2 and b_k == 2       # one forward, one backward
    assert y_k.dtype == dx_k.dtype == dp_k.dtype == torch.bfloat16
    for name, a, b in [("y", y_k, y_p), ("x", dx_k, dx_p),
                       ("posp", dp_k, dp_p)] + [(k, dw_k[k], dw_p[k])
                                                for k in dw_p]:
        assert a.dtype == b.dtype, name
        assert torch.isfinite(a.float()).all(), name
        _assert_bf16_train_close(name, a, b)


def _train_mask(T, lens_t, device):
    r = torch.arange(T, device=device)
    rc, cc = r[:, None] // 16, r[None, :] // 16
    return ((cc <= rc) & (cc >= rc - 4))[None] & \
        (r[None, None, :] < lens_t[:, None, None])


# (d_model, heads, ffn, conv kernel, T, lens): test widths and the flagship
TRAIN_BF16_SHAPES = [(64, 4, 256, 7, 45, [45, 36, 0]),
                     (256, 4, 2048, 15, 299,
                      [299, 250, 180, 120, 64, 33, 17, 5])]


@pytest.mark.cuda
@pytest.mark.parametrize("rates", [(0.0, 0.0), (0.1, 0.1)],
                         ids=["drop0", "drop0.1"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", TRAIN_BF16_SHAPES,
                         ids=lambda s: f"D{s[0]}T{s[4]}")
def test_train_layer_bf16_kernel_matches_plain(cuda_device, shape, causal,
                                               rates):
    """fused_conformer_layer_train's bf16 mode (CUDA forward + backward,
    masr_conformer_layer_train_*_bf16) == its bf16 twin with autograd on
    the same card, same dropout hash: the bf16 output, dx, dposp and the
    grads (bf16 for the product weights, f32 for the rows) of sum(y * w)
    within _assert_bf16_train_close; one forward and one backward launch,
    both counted as bf16."""
    from masr_tpu_torch.ops.cuda import conformer_layer_train as clt
    D, H, FF, K, T, lens = shape
    rate, att_rate = rates
    B = len(lens)
    layer = ConformerEncoderLayer(D, H, FF, cnn_module_kernel=K,
                                  causal=causal)
    layer.load_state_dict(seeded_state_dict(layer, seed=D + T + 3))
    layer = layer.to(cuda_device)
    g = torch.Generator().manual_seed(T + 9)
    x = torch.randn(B, T, D, generator=g).to(cuda_device, torch.bfloat16)
    w = torch.randn(B, T, D, generator=g).to(cuda_device)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (B,), generator=g,
                          dtype=torch.int32).to(cuda_device)
    with torch.no_grad():
        posp = torch.nn.functional.linear(
            sinusoid_position_encoding(torch.arange(T, device=cuda_device),
                                       D).to(torch.bfloat16),
            layer.self_attn.linear_pos.weight.to(torch.bfloat16))
        packed = cl.pack_layer_params(layer, torch.bfloat16)
    _check_train_bf16(
        clt.fused_conformer_layer_train,
        clt.fused_conformer_layer_train_plain,
        (x, _train_mask(T, lens_t, cuda_device), seeds, lens_t, posp, packed,
         w),
        dict(layer=3, n_head=H, ksize=K, causal=causal, rate=rate,
             att_rate=att_rate))


@pytest.mark.cuda
@pytest.mark.parametrize("rates", [(0.0, 0.0), (0.1, 0.1)],
                         ids=["drop0", "drop0.1"])
@pytest.mark.parametrize("causal", [True, False])
def test_train_layer_bf16_kernel_at_eff_tail_shape(cuda_device, causal,
                                                   rates):
    """fused_conformer_layer_train's bf16 mode at the Efficient-Conformer
    tail's shape (configs/efficient_conformer.yml after its stride: B=8,
    T'=150 of 299 subsampled frames, conv kernel 7, the chunk mask's
    [::2, ::2] view, the lengths halved rounding up) == its bf16 twin with
    autograd on the same card: the output, dx, dposp and every grad within
    _assert_bf16_train_close; one forward and one backward launch, both
    counted as bf16."""
    from masr_tpu_torch.ops.cuda import conformer_layer_train as clt
    D, H, FF, K = 256, 4, 2048, 7
    lens = [299, 281, 250, 220, 180, 150, 90, 33]
    rate, att_rate = rates
    B = len(lens)
    layer = ConformerEncoderLayer(D, H, FF, cnn_module_kernel=K,
                                  causal=causal)
    layer.load_state_dict(seeded_state_dict(layer, seed=157))
    layer = layer.to(cuda_device)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    mask = _train_mask(299, lens_t, cuda_device)[:, ::2, ::2]
    lens_t, T = (lens_t + 1) // 2, 150
    g = torch.Generator().manual_seed(T + 13)
    x = torch.randn(B, T, D, generator=g).to(cuda_device, torch.bfloat16)
    w = torch.randn(B, T, D, generator=g).to(cuda_device)
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (B,), generator=g,
                          dtype=torch.int32).to(cuda_device)
    with torch.no_grad():
        posp = torch.nn.functional.linear(
            sinusoid_position_encoding(torch.arange(T, device=cuda_device),
                                       D).to(torch.bfloat16),
            layer.self_attn.linear_pos.weight.to(torch.bfloat16))
        packed = cl.pack_layer_params(layer, torch.bfloat16)
    _check_train_bf16(
        clt.fused_conformer_layer_train,
        clt.fused_conformer_layer_train_plain,
        (x, mask, seeds, lens_t, posp, packed, w),
        dict(layer=5, n_head=H, ksize=K, causal=causal, rate=rate,
             att_rate=att_rate))


# (d_model, heads, ffn, conv kernel, T, lens, half): test widths and the
# flagship Squeezeformer's at full and half rate
SQ_TRAIN_BF16_SHAPES = [(64, 4, 256, 7, 45, [45, 36, 0], False),
                        (256, 4, 2048, 31, 299,
                         [299, 281, 250, 220, 180, 150, 90, 33], False),
                        (256, 4, 2048, 31, 299,
                         [299, 281, 250, 220, 180, 150, 90, 33], True)]


@pytest.mark.cuda
@pytest.mark.parametrize("rates", [(0.0, 0.0), (0.1, 0.1)],
                         ids=["drop0", "drop0.1"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SQ_TRAIN_BF16_SHAPES,
                         ids=["D64T45", "D256T299", "D256T150half"])
def test_sq_train_layer_bf16_kernel_matches_plain(cuda_device, shape, causal,
                                                  rates):
    """fused_squeezeformer_layer_train's bf16 mode (the unfolded bf16 pack,
    masr_sq_layer_train_*_bf16) == its bf16 twin with autograd on the same
    card, at full rate and at half rate (the mask's [::2, ::2], lengths
    halved rounding up): the output, dx, dposp and every grad (the four
    adaptive scales' included) within _assert_bf16_train_close; one
    forward and one backward launch, both counted as bf16."""
    from masr_tpu_torch.ops.cuda import squeezeformer_layer_train as sqt
    from masr_tpu_torch.ops.cuda.squeezeformer_layer import \
        pack_sq_layer_params
    D, H, FF, K, T, lens, half = shape
    rate, att_rate = rates
    B = len(lens)
    layer = _sq_layer(D, H, FF, K, causal, "layer_norm", D + T + 4,
                      cuda_device)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    mask = _train_mask(T, lens_t, cuda_device)
    if half:
        mask, lens_t, T = mask[:, ::2, ::2], (lens_t + 1) // 2, (T + 1) // 2
    g = torch.Generator().manual_seed(T + 11)
    x = torch.randn(B, T, D, generator=g).to(cuda_device, torch.bfloat16)
    w = torch.randn(B, T, D, generator=g).to(cuda_device)
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (B,), generator=g,
                          dtype=torch.int32).to(cuda_device)
    with torch.no_grad():
        posp = torch.nn.functional.linear(
            sinusoid_position_encoding(torch.arange(T, device=cuda_device),
                                       D).to(torch.bfloat16),
            layer.self_attn.linear_pos.weight.to(torch.bfloat16))
        packed = pack_sq_layer_params(layer, torch.bfloat16)
    assert tuple(packed["ada"].shape) == (4, 2, D)
    _check_train_bf16(
        sqt.fused_squeezeformer_layer_train,
        sqt.fused_squeezeformer_layer_train_plain,
        (x, mask, seeds, lens_t, posp, packed, w),
        dict(layer=6, n_head=H, ksize=K, causal=causal, rate=rate,
             att_rate=att_rate))


@pytest.mark.cuda
def test_train_layers_bf16_dtype_refusals(cuda_device):
    """The training kernels take f32 or bf16 operands throughout: bf16 x
    with the f32 pack, f32 x with the bf16 pack, a bf16 LN row, f16, and
    (row 7) the folded f32 pack under bf16 operands each raise ValueError
    before any launch."""
    from masr_tpu_torch.ops.cuda import conformer_layer_train as clt
    from masr_tpu_torch.ops.cuda import squeezeformer_layer_train as sqt
    from masr_tpu_torch.ops.cuda.squeezeformer_layer import \
        pack_sq_layer_params
    D, H, FF, K, T, B = 64, 4, 256, 7, 16, 2
    layer = ConformerEncoderLayer(D, H, FF, cnn_module_kernel=K,
                                  causal=True).to(cuda_device)
    sq = _sq_layer(D, H, FF, K, True, "layer_norm", 5, cuda_device)
    lens = torch.tensor([T, 9], dtype=torch.int32, device=cuda_device)
    mask = _train_mask(T, lens, cuda_device)
    seeds = torch.zeros(B, dtype=torch.int32, device=cuda_device)
    x = torch.randn(B, T, D, device=cuda_device)
    posp = torch.randn(T, D, device=cuda_device)
    bf = torch.bfloat16
    with torch.no_grad():
        cases = []
        for fn, counter, mod, pack in (
                (clt.fused_conformer_layer_train, clt.fused_conformer_layer_train,
                 layer, cl.pack_layer_params),
                (sqt.fused_squeezeformer_layer_train,
                 sqt.fused_squeezeformer_layer_train, sq,
                 pack_sq_layer_params)):
            p32, p16 = pack(mod), pack(mod, bf)
            bad_row = dict(p16, lnw=p16["lnw"].to(bf))
            cases += [(fn, counter, x.to(bf), posp.to(bf), p32),
                      (fn, counter, x, posp, p16),
                      (fn, counter, x.to(bf), posp.to(bf), bad_row),
                      (fn, counter, x.half(), posp.half(), p32)]
    for fn, counter, xx, pp, pk in cases:
        before = counter.launches
        with pytest.raises(ValueError):
            fn(xx, mask, seeds, lens, pp, pk, layer=0, n_head=H, ksize=K,
               causal=True)
        assert counter.launches == before


# --------------------------------------------------------------------------- #
# the bf16 training layers' product (csrc/train_wgmma.cuh) on its own
# --------------------------------------------------------------------------- #
def _bf16_rows(shape, g, device, scale=1.0):
    return (scale * torch.randn(*shape, generator=g)).to(device,
                                                         torch.bfloat16)


def _heads(x, B, T, H):
    """(B, T, D) rows → the (B, H, T, d_k) head view the attention's
    batched products read (strided, no copy)."""
    return x.view(B, T, H, -1).permute(0, 2, 1, 3)


def _check_product(got, want, absref, bf16=False):
    """got vs want: f32 sums of the same exact bf16 products in another
    order (1e-4 of sum |a||b|), plus one bf16 rounding of the value for a
    bf16 output."""
    tol = 1e-4 * absref + 1e-6
    if bf16:
        tol = tol + 2.0 ** -8 * want.abs()
    err = (got.float() - want).abs()
    assert bool((err <= tol).all()), (err.max().item(),
                                      (err - tol).max().item())


def _absref(a, b, ta, tb):
    A = a.float().abs()
    B = b.float().abs()
    return (A.transpose(-1, -2) if ta else A) @ (B.transpose(-1, -2) if tb
                                                else B)


# (name, M, N, K, ta, tb, split): the layers' product kinds at ragged and
# full shapes: mm_nn (forward, N = F and D), mm_nt (input grads), mm_tn
# (weight grads, K = B*T' split over K, or one slice)
PRODUCT_SHAPES = [("nn_ragged", 135, 96, 40, False, False, False),
                  ("nn_w1", 2392, 2048, 256, False, False, False),
                  ("nn_w2", 2392, 256, 2048, False, False, False),
                  ("nt_ragged", 135, 72, 64, False, True, False),
                  ("nt_dz", 2392, 2048, 256, False, True, False),
                  ("tn_split", 256, 512, 2392, True, False, True),
                  ("tn_split_ragged", 64, 256, 135, True, False, True),
                  ("tn_one_slice", 96, 64, 200, True, False, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PRODUCT_SHAPES, ids=lambda s: s[0])
def test_train_product_matches_plain(cuda_device, shape):
    """train_product_bf16 (TMA tiles, wgmma) == its plain twin (bf16
    operands, f32 sums) within _check_product, into f32 and bf16 outputs,
    over transposed operands, ragged M / N / K and split-K; one launch a
    call."""
    from masr_tpu_torch.ops.cuda import train_product as tp
    _, M, N, K, ta, tb, split = shape
    g = torch.Generator().manual_seed(M + N + K)
    a = _bf16_rows((K, M) if ta else (M, K), g, cuda_device)
    b = _bf16_rows((N, K) if tb else (K, N), g, cuda_device)
    want = tp.train_product_plain(a, b, ta=ta, tb=tb)[0]
    absref = _absref(a, b, ta, tb)
    for kind in ("f32", "bf16"):
        out = torch.full((M, N), float("nan"), device=cuda_device)
        out_b = out.to(torch.bfloat16)
        before = tp.train_product_bf16.launches
        tp.train_product_bf16(a, b, ta=ta, tb=tb, split=split,
                              out=out if kind == "f32" else None,
                              out_bf16=out_b if kind == "bf16" else None)
        torch.cuda.synchronize()
        assert tp.train_product_bf16.launches == before + 1
        _check_product(out if kind == "f32" else out_b, want, absref,
                       bf16=kind == "bf16")


@pytest.mark.cuda
@pytest.mark.parametrize("T,dk", [(45, 16), (150, 16), (299, 16), (45, 36)])
def test_train_product_attention_batches(cuda_device, T, dk):
    """The attention's batched products as att_fwd_bf / att_bwd_bf lay
    them out, at rows whose stride is not a multiple of 16 bytes in f32
    (T' = 45, 150, 299; the bf16 probabilities padded to 8) and at a head
    width of 36 (head slices 72 bytes apart, which TMA cannot step): the
    scores (q+u).k^T into (h, B, T, T) rows, (q+v).posp^T with posp
    shared across utterances and R = the scores, P.v from padded rows
    into the (B, T, D) head slices, Pd^T.dO, dS.k, dS^T.q and dposp (per
    head over K = B*T', split) against the plain twin."""
    from masr_tpu_torch.ops.cuda import train_product as tp
    B, H = 3, 4
    D, Tp = H * dk, (T + 7) // 8 * 8
    g = torch.Generator().manual_seed(T)
    q, k, v, dO = (_bf16_rows((B, T, D), g, cuda_device) for _ in range(4))
    posp = _bf16_rows((T, D), g, cuda_device)
    pad = _bf16_rows((H, B, T, Tp), g, cuda_device)
    P = pad[..., :T].permute(1, 0, 2, 3)            # (B, H, T, T) view
    qh, kh, vh, dOh = (_heads(x, B, T, H) for x in (q, k, v, dO))
    ph = _heads(posp[None], 1, T, H).expand(B, H, T, dk)
    scores = torch.empty(H, B, T, T, device=cuda_device)
    sv = scores.permute(1, 0, 2, 3)
    scale = dk ** -0.5
    tp.train_product_bf16(qh, kh, tb=True, out=sv, alpha=scale)
    want = tp.train_product_plain(qh, kh, tb=True, alpha=scale)[0]
    _check_product(sv, want, scale * _absref(qh, kh, False, True))
    tp.train_product_bf16(qh, ph, tb=True, out=sv, alpha=scale, R=sv)
    want = want + tp.train_product_plain(qh, ph, tb=True, alpha=scale)[0]
    _check_product(sv, want, scale * (_absref(qh, kh, False, True) +
                                      _absref(qh, ph, False, True)))
    for a, b, ta, kind in ((P, vh, False, "P.v"), (P, dOh, True, "Pd^T.dO"),
                           (P, kh, False, "dS.k"), (P, qh, True, "dS^T.q")):
        o = torch.empty(B, T, D, device=cuda_device)
        ob = torch.empty(B, T, D, device=cuda_device, dtype=torch.bfloat16)
        oh, obh = _heads(o, B, T, H), _heads(ob, B, T, H)
        tp.train_product_bf16(a, b, ta=ta, out=oh, out_bf16=obh)
        want = tp.train_product_plain(a, b, ta=ta)[0]
        absref = _absref(a, b, ta, False)
        _check_product(oh, want, absref)
        _check_product(obh, want, absref, bf16=True)
    # dposp[:, head h] = sum over b of dS[h, b]^T . (q+v)[b, :, head h]
    dS = pad[..., :T].reshape(H, B * T, T)
    qv = q.view(B * T, H, dk).permute(1, 0, 2)
    dposp = torch.empty(T, D, device=cuda_device, dtype=torch.bfloat16)
    dh = dposp.view(T, H, dk).permute(1, 0, 2)
    tp.train_product_bf16(dS, qv, ta=True, split=True, out_bf16=dh)
    want = tp.train_product_plain(dS, qv, ta=True)[0]
    _check_product(dh, want, _absref(dS, qv, True, False), bf16=True)


def _unaligned(shape, g, device, pad=3, shift=0):
    """A bf16 (..., rows, inner) operand whose row stride (inner + pad) is
    not a multiple of 8 elements, starting `shift` elements into its
    storage: a layout TMA cannot read."""
    *lead, rows, inner = shape
    n = 1
    for d in lead:
        n *= d
    buf = _bf16_rows((n * rows * (inner + pad) + shift,), g, device)
    return buf[shift:].view(*lead, rows, inner + pad)[..., :inner]


# (name, M, N, K, ta, tb, split, which operands TMA cannot read)
UNALIGNED_PRODUCTS = [("nn_both", 135, 96, 40, False, False, False, "ab"),
                      ("nt_a", 135, 72, 64, False, True, False, "a"),
                      ("tn_b", 96, 64, 200, True, False, False, "b"),
                      ("tn_split_both", 64, 256, 1199, True, False, True,
                       "ab"),
                      ("nn_shifted_base", 200, 136, 72, False, False, False,
                       "shift")]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", UNALIGNED_PRODUCTS, ids=lambda s: s[0])
def test_train_product_unaligned_operands(cuda_device, shape):
    """Operands TMA cannot read (a row stride not a multiple of 16 bytes,
    a base not 16-byte aligned) go through the producer warp's lanes into
    the same swizzled tiles: train_product_bf16 == its plain twin within
    _check_product, alone or beside a TMA operand, with split-K; the bits
    equal those of the same values in aligned storage."""
    from masr_tpu_torch.ops.cuda import train_product as tp
    _, M, N, K, ta, tb, split, which = shape
    g = torch.Generator().manual_seed(M * 7 + K)
    sa, sb = (K, M) if ta else (M, K), (N, K) if tb else (K, N)
    if which == "shift":
        a = _unaligned(sa, g, cuda_device, pad=0, shift=1)
        b = _unaligned(sb, g, cuda_device, pad=0, shift=3)
    else:
        a = (_unaligned(sa, g, cuda_device) if "a" in which
             else _bf16_rows(sa, g, cuda_device))
        b = (_unaligned(sb, g, cuda_device) if "b" in which
             else _bf16_rows(sb, g, cuda_device))
    want = tp.train_product_plain(a, b, ta=ta, tb=tb)[0]
    got = torch.empty(M, N, device=cuda_device)
    aligned = torch.empty(M, N, device=cuda_device)
    tp.train_product_bf16(a, b, ta=ta, tb=tb, split=split, out=got)
    tp.train_product_bf16(a.contiguous(), b.contiguous(), ta=ta, tb=tb,
                          split=split, out=aligned)
    torch.cuda.synchronize()
    _check_product(got, want, _absref(a, b, ta, tb))
    assert torch.equal(got, aligned)


# (name, epilogue keywords): each of Epi's modes on its own
EPILOGUES = ["bias", "silu_pre", "dsilu", "dropout", "row_mask",
             "residual_in_place", "round"]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", EPILOGUES)
def test_train_product_epilogues(cuda_device, mode):
    """train_product_bf16's epilogue (training.cuh's Epi element for
    element) == the plain twin's in each mode: bias, SiLU saving the
    pre-activation, x dSiLU(aux), the dropout hash (rate 0.1), the row
    mask of lens, R + scale v with R the output itself, the output
    rounded to bf16 values; f32 and bf16 outputs."""
    from masr_tpu_torch.ops.cuda import train_product as tp
    B, T, K, N = 3, 45, 64, 96
    M = B * T
    g = torch.Generator().manual_seed(len(mode))
    a = _bf16_rows((M, K), g, cuda_device)
    w = _bf16_rows((K, N), g, cuda_device, 0.2)
    kw = {"T": T}
    out = torch.zeros(M, N, device=cuda_device)
    pre = None
    if mode == "bias":
        kw["bias"] = torch.randn(N, generator=g).to(cuda_device)
    elif mode == "silu_pre":
        kw.update(bias=torch.randn(N, generator=g).to(cuda_device), act=1)
        pre = torch.zeros(M, N, device=cuda_device)
    elif mode == "dsilu":
        kw.update(act=2, aux=torch.randn(M, N, generator=g).to(cuda_device))
    elif mode == "dropout":
        kw.update(seeds=torch.randint(-2 ** 31, 2 ** 31 - 1, (B,),
                                      generator=g, dtype=torch.int32)
                  .to(cuda_device), layer=3, site=5, rate=0.1, row0=2)
    elif mode == "row_mask":
        kw["lens"] = torch.tensor([45, 17, 0], dtype=torch.int32,
                                  device=cuda_device)
    elif mode == "residual_in_place":
        out = torch.randn(M, N, generator=g).to(cuda_device)
        kw.update(R=out, res_scale=0.5)
    else:
        kw["round_c"] = True
    want, want_pre = tp.train_product_plain(a, w, **kw)
    absref = _absref(a, w, False, False)
    if mode == "dsilu":
        absref = absref * 1.1
    out_b = torch.empty(M, N, device=cuda_device, dtype=torch.bfloat16)
    tp.train_product_bf16(a, w, out=out, out_bf16=out_b, pre=pre, **kw)
    torch.cuda.synchronize()
    _check_product(out, want, absref)
    _check_product(out_b, want, absref, bf16=True)
    if pre is not None:
        _check_product(pre, want_pre, absref)
    if mode == "round":
        assert torch.equal(out, out.to(torch.bfloat16).float())


# (d_model, heads, ffn): widths whose bf16 rows TMA cannot step: a head
# width of 36 (72-byte head slices), and D, d_k and F none of them a
# multiple of 8 (rows and weight halves not 16-byte aligned)
UNALIGNED_TRAIN_WIDTHS = [(144, 4, 576), (100, 4, 300)]


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["conformer", "squeezeformer"])
@pytest.mark.parametrize("width", UNALIGNED_TRAIN_WIDTHS,
                         ids=lambda w: f"D{w[0]}H{w[1]}F{w[2]}")
def test_train_layers_bf16_unaligned_widths(cuda_device, width, family):
    """Rows 3 and 7's bf16 modes take every width their f32 modes take:
    at d_k = 36 (D = 144, h = 4) and at D = 100, F = 300, with dropout,
    the output, dx, dposp and every grad == the bf16 twin's within
    _assert_bf16_train_close; one forward and one backward launch."""
    from masr_tpu_torch.ops.cuda import conformer_layer_train as clt
    from masr_tpu_torch.ops.cuda import squeezeformer_layer_train as sqt
    from masr_tpu_torch.ops.cuda.squeezeformer_layer import \
        pack_sq_layer_params
    D, H, FF = width
    K, T, lens = 7, 45, [45, 36, 0]
    B = len(lens)
    if family == "conformer":
        layer = ConformerEncoderLayer(D, H, FF, cnn_module_kernel=K,
                                      causal=True)
        layer.load_state_dict(seeded_state_dict(layer, seed=D + 5))
        layer = layer.to(cuda_device)
        fn, plain = (clt.fused_conformer_layer_train,
                     clt.fused_conformer_layer_train_plain)
        with torch.no_grad():
            packed = cl.pack_layer_params(layer, torch.bfloat16)
    else:
        layer = _sq_layer(D, H, FF, K, True, "layer_norm", D + 6,
                          cuda_device)
        fn, plain = (sqt.fused_squeezeformer_layer_train,
                     sqt.fused_squeezeformer_layer_train_plain)
        with torch.no_grad():
            packed = pack_sq_layer_params(layer, torch.bfloat16)
    g = torch.Generator().manual_seed(D + 1)
    x = torch.randn(B, T, D, generator=g).to(cuda_device, torch.bfloat16)
    w = torch.randn(B, T, D, generator=g).to(cuda_device)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (B,), generator=g,
                          dtype=torch.int32).to(cuda_device)
    with torch.no_grad():
        posp = torch.nn.functional.linear(
            sinusoid_position_encoding(torch.arange(T, device=cuda_device),
                                       D).to(torch.bfloat16),
            layer.self_attn.linear_pos.weight.to(torch.bfloat16))
    _check_train_bf16(
        fn, plain,
        (x, _train_mask(T, lens_t, cuda_device), seeds, lens_t, posp, packed,
         w),
        dict(layer=2, n_head=H, ksize=K, causal=True, rate=0.1,
             att_rate=0.1))


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["conformer", "squeezeformer"])
def test_train_layers_bf16_launch_list(cuda_device, family):
    """One bf16 forward + backward of row 3 or row 7 launches the wgmma
    product (tw_gemm_kernel) and never common.cuh's gemm_tc_kernel, and
    widens no bf16 weight: the only bf16 → f32 conversions are x's and
    dy's (profiler kernel names)."""
    from torch.profiler import ProfilerActivity, profile
    from masr_tpu_torch.ops.cuda import conformer_layer_train as clt
    from masr_tpu_torch.ops.cuda import squeezeformer_layer_train as sqt
    from masr_tpu_torch.ops.cuda.squeezeformer_layer import \
        pack_sq_layer_params
    D, H, FF, K, T, lens = 64, 4, 256, 7, 45, [45, 36, 0]
    B = len(lens)
    if family == "conformer":
        layer = ConformerEncoderLayer(D, H, FF, cnn_module_kernel=K,
                                      causal=True).to(cuda_device)
        fn, pack = clt.fused_conformer_layer_train, cl.pack_layer_params
    else:
        layer = _sq_layer(D, H, FF, K, True, "layer_norm", 5, cuda_device)
        fn, pack = sqt.fused_squeezeformer_layer_train, pack_sq_layer_params
    lens_t = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    mask = _train_mask(T, lens_t, cuda_device)
    seeds = torch.zeros(B, dtype=torch.int32, device=cuda_device)
    x = torch.randn(B, T, D, device=cuda_device).to(torch.bfloat16)
    x.requires_grad_(True)
    with torch.no_grad():
        posp = torch.randn(T, D, device=cuda_device).to(torch.bfloat16)
        packed = pack(layer, torch.bfloat16)
    packed = {k: v.requires_grad_(True) for k, v in packed.items()}

    def run():
        y = fn(x, mask, seeds, lens_t, posp, packed, layer=0, n_head=H,
               ksize=K, causal=True, rate=0.1, att_rate=0.1)
        y.float().sum().backward()

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    counts = {e.key: e.count for e in prof.key_averages()}
    assert any("tw_gemm_kernel" in n for n in names), names
    assert not any("gemm_tc_kernel" in n for n in names), names
    widen = sum(c for n, c in counts.items()
                if "convert_kernel<unsigned short, float>" in n)
    assert widen == 2, (widen, names)


# --------------------------------------------------------------------------- #
# the user tools and the GUI controller on the card
# --------------------------------------------------------------------------- #
EXAMPLE = "examples/tiny_zh_synth/inference_model"


def _example_speech(path, k):
    """The example bundle's k-th training sentence (SyntheticTTS) with half
    a second of -60 dB noise on each side, written to `path` → samples."""
    import numpy as np
    import chip_smoke
    from masr_tpu_torch.audio import AudioSegment
    from masr_tpu_torch.audio.io import write_wave
    from masr_tpu_torch.audio.synth_tts import SyntheticTTS
    voice = SyntheticTTS(sample_rate=16000).render(
        chip_smoke.corpus_sentences()[k], 0)
    pad = np.zeros(8000, np.float32)
    wav = np.concatenate([pad, voice, pad]) + 1e-3 * np.random.RandomState(
        k).standard_normal(len(voice) + 16000).astype(np.float32)
    write_wave(path, wav, 16000)
    return AudioSegment.from_file(path).samples


@pytest.mark.cuda
def test_tune_device_grid_on_the_card(cuda_device, tmp_path):
    """`masr_tpu_torch.tools.tune` with --use_device on the card over the
    example bundle, 4 synthesized utterances and a character bigram ARPA
    of its training sentences (2x2 grid): the cached probs come from the
    full-context layer kernel (2 layers x 4 utterances) and are within
    1e-4 of the CPU run's (the card-vs-CPU probs tolerance); every grid
    point's error and the best pair equal the CPU run's."""
    import json
    import yaml
    import chip_smoke
    from masr_tpu_torch.tools import tune
    rows = []
    for k in range(4):
        path = str(tmp_path / f"utt_{k}.wav")
        samples = _example_speech(path, k)
        rows.append({"audio_filepath": path, "duration": len(samples) / 16000,
                     "text": chip_smoke.corpus_sentences()[k]})
    manifest = tmp_path / "manifest.test"
    manifest.write_text("".join(json.dumps(r, ensure_ascii=False) + "\n"
                                for r in rows), encoding="utf-8")
    lm = chip_smoke.write_char_bigram_arpa(chip_smoke.corpus_sentences(),
                                           str(tmp_path / "lm" / "lm.arpa"))
    with open(f"{EXAMPLE}/inference.json", encoding="utf-8") as f:
        pre = json.load(f)["preprocess_conf"]
    cfg = tmp_path / "tune.yml"
    cfg.write_text(yaml.safe_dump({
        "preprocess_conf": pre, "metrics_type": "cer",
        "dataset_conf": {"test_manifest": str(manifest)},
        "ctc_beam_search_decoder_conf": dict(
            beam_size=10, cutoff_top_n=40, language_model_path=lm)},
        allow_unicode=True), encoding="utf-8")
    argv = ["--configs", str(cfg), "--model_dir", EXAMPLE, "--num_utts", "4",
            "--num_alphas", "2", "--num_betas", "2", "--alpha_from", "0.5",
            "--alpha_to", "2.0", "--beta_from", "0.5", "--beta_to", "3.0",
            "--use_device", "True"]
    before = cl.fused_conformer_layer.launches
    card = tune.main(argv)
    assert cl.fused_conformer_layer.launches - before == 2 * 4
    cpu = tune.main(argv + ["--use_gpu", "False"])
    for (p, t), (q, u) in zip(card["cached"], cpu["cached"]):
        assert t == u and p.shape == q.shape
        assert float(abs(p - q).max()) <= 1e-4
    assert card["grid"] == cpu["grid"] and card["best"] == cpu["best"]


@pytest.mark.cuda
def test_streaming_recognizer_on_the_card(cuda_device, tmp_path):
    """The GUI controller's StreamingRecognizer over the example bundle's
    MASRPredictor on the card, fed a file through FileSource: the chunk
    kernel runs every window (2 layers each); the last partial equals
    predict_stream(whole, is_end=True) on the card and the same flow's on
    the CPU (texts exactly: the trained bundle's frames peak); on_log gets
    only the save message."""
    from masr_tpu_torch.infer.gui_app import FileSource, StreamingRecognizer
    from masr_tpu_torch.infer.predictor import MASRPredictor
    samples = _example_speech(str(tmp_path / "speech.wav"), 5)
    out = {}
    for dev in (cuda_device, "cpu"):
        pred = MASRPredictor(EXAMPLE, device=dev, warmup=False)
        partials, logs = [], []
        rec = StreamingRecognizer(pred, output_path=str(tmp_path / str(dev)),
                                  on_partial=lambda t, s: partials.append(t),
                                  on_log=logs.append)
        before = ck.fused_chunk_layer.launches
        rec.start(FileSource(samples))
        rec._threads[0].join(60)
        saved = rec.stop(save=True)
        launches = ck.fused_chunk_layer.launches - before
        assert len(logs) == 1 and saved in logs[0], logs
        whole = pred.predict_stream(samples, is_end=True)["text"]
        pred.reset_stream()
        assert partials and partials[-1] == whole
        out[str(dev)] = (partials[-1], launches)
    (card_text, card_launches), (cpu_text, cpu_launches) = out.values()
    assert card_text == cpu_text and card_text
    assert card_launches > 0 and card_launches % 2 == 0 and cpu_launches == 0
