"""The CTC kernel's numerical scheme, rehearsed on the CPU.

masr_tpu_torch/csrc/ctc_loss.cu runs its alpha and beta recursions in f32
in log2 units, relative to per-chain offsets summed in f64, and scatters
the occupancies by token group. `ctc_scheme_mirror` repeats that
arithmetic in plain PyTorch; here it is held against autograd of
`ctc_loss_plain` in f64 with the card's gates (NLL rtol 1e-5; grad within
max(2 x the f32 plain twin's error, 1e-4) of the f64 twin), at
chip_smoke's CTC shape and on the cases of tests/test_torch_ctc.py, and
against the Pallas kernel (interpret mode) where the two conventions of an
empty chain meet. A precision fault of the scheme shows here before it
shows on the card (the first f32 kernel, without offsets, landed 18x the
f32 twin's error from the f64 one).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from masr_tpu.ops.pallas import ctc_loss as M
from masr_tpu_torch.ops.cuda import ctc_loss as C
from test_torch_threads import one_torch_thread  # noqa: F401

GRAD_FLOOR = 1e-4


def _plain_grads(logits, logit_lens, labels, label_lens, w):
    """Autograd of the plain twin in f32 and in f64 → {dtype: (nll, grad)}
    as f64 tensors."""
    out = {}
    for dt in (torch.float32, torch.float64):
        x = torch.as_tensor(logits).detach().to(dt).clone()
        x.requires_grad_(True)
        nll = C.ctc_loss_plain(x, torch.as_tensor(logit_lens),
                               torch.as_tensor(labels).clamp(min=0),
                               torch.as_tensor(label_lens))
        (nll * torch.as_tensor(w).to(dt)).sum().backward()
        out[dt] = (nll.detach().double(), x.grad.double())
    return out


def _check(logits, logit_lens, labels, label_lens, w, rows=None):
    """The mirror against the plain twin: NLL rtol 1e-5 atol 1e-4 vs f64,
    grad (over `rows` of the batch, all by default) within max(2 x the f32
    twin's error, 1e-4) of the f64 twin's. → (mirror error, f32 error)."""
    ref = _plain_grads(logits, logit_lens, labels, label_lens, w)
    nll, grad = C.ctc_scheme_mirror(
        torch.as_tensor(logits), torch.as_tensor(logit_lens),
        torch.as_tensor(labels), torch.as_tensor(label_lens),
        torch.as_tensor(w))
    assert torch.isfinite(nll).all() and torch.isfinite(grad).all()
    n64, g64 = ref[torch.float64]
    torch.testing.assert_close(nll.double(), n64, rtol=1e-5, atol=1e-4)
    rows = slice(None) if rows is None else rows
    err = (grad.double() - g64)[rows].abs().max().item()
    p32 = (ref[torch.float32][1] - g64)[rows].abs().max().item()
    assert err <= max(2 * p32, GRAD_FLOOR), (err, p32)
    return err, p32


def _smoke_case(seed=4):
    """chip_smoke's CTC inputs: B=8, T'=299, V=4000, label lengths 5..80
    (S = 161), frames 33..299."""
    g = torch.Generator().manual_seed(seed)
    T, V = 299, 4000
    label_lens = torch.tensor([5, 10, 15, 20, 25, 30, 40, 80],
                              dtype=torch.int32)
    lens = torch.tensor([33, 90, 150, 180, 220, 250, 281, T],
                        dtype=torch.int32)
    logits = 2 * torch.randn(8, T, V, generator=g)
    labels = torch.randint(1, V - 1, (8, 80), generator=g)
    labels[torch.arange(80)[None] >= label_lens[:, None]] = -1
    return logits, lens, labels.int(), label_lens


def _case(seed, B, T, V, L, repeats=False, min_label=1):
    """tests/test_torch_ctc.py's random padded batch (every alignment
    feasible: tlen >= 2L + 1)."""
    rs = np.random.RandomState(seed)
    logits = (rs.standard_normal((B, T, V)) * 2.0).astype(np.float32)
    labels = rs.randint(1, 4 if repeats else V, (B, L)).astype(np.int32)
    label_lens = rs.randint(min_label, L + 1, (B,)).astype(np.int32)
    logit_lens = rs.randint(min(2 * L + 1, T), T + 1, (B,)).astype(np.int32)
    labels[np.arange(L)[None] >= label_lens[:, None]] = -1
    return logits, logit_lens, labels, label_lens


def _weights(seed, B):
    return np.random.RandomState(seed + 100).standard_normal(B).astype(
        np.float32)


def test_scheme_at_the_smoke_shape():
    """B=8, T'=299, V=4000, S=161 (|log Z| up to ~2.5e3): the scheme's grad
    error stays under the f32 twin's (measured 6.0e-5 against 1.4e-4)."""
    logits, lens, labels, label_lens = _smoke_case()
    w = torch.randn(8, generator=torch.Generator().manual_seed(3))
    err, p32 = _check(logits, lens, labels, label_lens, w)
    assert err < p32


@pytest.mark.parametrize("seed,B,T,V,L,repeats",
                         [(0, 4, 37, 23, 9, False), (1, 4, 37, 23, 9, True),
                          (3, 3, 25, 17, 5, False), (4, 2, 21, 11, 10, True)])
def test_scheme_on_the_plain_cases(seed, B, T, V, L, repeats):
    """tests/test_torch_ctc.py's cases: padded labels, repeated labels, T
    near the 2L + 1 minimum."""
    args = _case(seed, B, T, V, L, repeats)
    _check(*args, _weights(seed, B))


def test_scheme_past_the_tpu_state_cap():
    """S = 2L + 1 = 141 > 128 states (and S > 128 at one label per lane)."""
    args = _case(5, 2, 150, 13, 70, min_label=64)
    _check(*args, np.ones(2, np.float32))


def test_scheme_empty_label():
    """label_len 0: one state (blank), beside a batch of longer labels."""
    logits, logit_lens, labels, label_lens = _case(6, 3, 30, 19, 6)
    labels[1] = -1
    label_lens[1] = 0
    _check(logits, logit_lens, labels, label_lens, _weights(6, 3))


def test_scheme_every_label_the_same():
    """Every label token equal, so every skip is barred; frames as few as
    the alignment allows (L + L - 1)."""
    rs = np.random.RandomState(11)
    L = 12
    logits = (2 * rs.standard_normal((2, 40, 9))).astype(np.float32)
    labels = np.full((2, L), 4, np.int32)
    _check(logits, np.asarray([40, 2 * L - 1], np.int32), labels,
           np.asarray([L, L], np.int32), _weights(11, 2))


def test_scheme_infeasible_alignment():
    """More labels than frames allow: NLL ~1e30 and finite as the plain
    twin's, every grad finite; the feasible sequence's grad within the
    gate (the infeasible one's follows the Pallas kernel's clipped
    occupancies, not the plain twin's autograd through -1e30)."""
    logits, _, labels, label_lens = _case(8, 2, 12, 9, 8, min_label=8)
    logit_lens = np.asarray([12, 5], np.int32)
    _check(logits, logit_lens, labels, label_lens, np.ones(2, np.float32),
           rows=slice(0, 1))
    nll, _ = C.ctc_scheme_mirror(*(torch.as_tensor(a) for a in (
        logits, logit_lens, labels, label_lens)), torch.ones(2))
    assert nll[1] > 1e29 and nll[0] < 1e3


def test_scheme_empty_chain_follows_pallas():
    """tlen = 0 and tlen = T: the Pallas kernel takes log Z from frame 0's
    alpha and gives no occupancy to a chain of 0 frames; the mirror (the
    kernel's convention) == ctc_loss_pallas in interpret mode, losses rtol
    1e-5, grads atol 2e-5."""
    logits, _, labels, label_lens = _case(12, 3, 16, 7, 3)
    logit_lens = np.asarray([0, 16, 9], np.int32)
    label_lens = np.asarray([1, 3, 2], np.int32)
    labels[np.arange(3)[None] >= label_lens[:, None]] = -1
    w = _weights(12, 3)
    nll, grad = C.ctc_scheme_mirror(*(torch.as_tensor(a) for a in (
        logits, logit_lens, labels, label_lens, w)))
    T, L = 16, 3
    lpad = (np.arange(T)[None] >= logit_lens[:, None]).astype(np.float32)
    ypad = (np.arange(L)[None] >= label_lens[:, None]).astype(np.float32)
    lab = jnp.asarray(np.where(labels < 0, 0, labels))

    def total(lg):
        n = M.ctc_loss_pallas(lg, jnp.asarray(lpad), lab, jnp.asarray(ypad),
                              blank_id=0, interpret=True)
        return jnp.sum(n * w), n

    (_, want), g_want = jax.jit(jax.value_and_grad(total, has_aux=True))(
        jnp.asarray(logits))
    np.testing.assert_allclose(nll.numpy(), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(g_want), atol=2e-5)
    assert float(grad[0].abs().max()) == 0.0


def test_token_groups_match_a_brute_force_scatter():
    """The kernel's table: each state s < n in exactly one group, groups in
    order of their first state, s ascending in a group, one token a
    group; the grouped sums == the one-hot scatter of the occupancies
    (integers in f64: exact). Repeated tokens, a label equal to the blank,
    an empty label."""
    rs = np.random.RandomState(13)
    B, L, V = 4, 9, 6
    labels = torch.as_tensor(rs.randint(0, 4, (B, L)).astype(np.int32))
    label_lens = torch.tensor([9, 5, 0, 7], dtype=torch.int32)
    tables = C.token_groups(labels, label_lens, blank=0)
    for b, groups in enumerate(tables):
        n = 2 * int(label_lens[b]) + 1
        lab = labels[b].tolist()
        seen = [s for _, sts in groups for s in sts]
        assert sorted(seen) == list(range(n))
        assert [sts[0] for _, sts in groups] == sorted(
            sts[0] for _, sts in groups)
        assert len({tok for tok, _ in groups}) == len(groups)
        gam = torch.as_tensor(rs.randint(0, 1000, (5, n)).astype(np.float64))
        tok_of = [lab[(s - 1) // 2] if s % 2 else 0 for s in range(n)]
        want = gam @ torch.nn.functional.one_hot(
            torch.tensor(tok_of), V).double()
        got = torch.zeros(5, V, dtype=torch.float64)
        for tok, sts in groups:
            assert sts == sorted(sts)
            assert all(tok_of[s] == tok for s in sts)
            got[:, tok] = sum(gam[:, s] for s in sts)
        assert torch.equal(got, want)


def test_scheme_keeps_the_chain_values_small():
    """The offsets carry the magnitude: at the smoke shape the largest
    stored alpha of every frame lies within [-128, 4] log2 units of the
    frame's offset (an f32 ulp there <= 7.6e-6), while the offsets reach
    past 3e3."""
    logits, lens, labels, label_lens = _smoke_case()
    B, T, _ = logits.shape
    x = logits.float()
    lse = torch.logsumexp(x, -1)
    states, valid, skip, n = C._states(labels.long().clamp(min=0),
                                        label_lens, 0)
    S = states.shape[1]
    lp2 = torch.where(valid[:, None, :], (x.gather(
        2, states[:, None, :].expand(B, T, S)) - lse[..., None]) * C.LOG2E,
        C.NEG2).float()
    skip2 = torch.where(skip == 0, 0.0, C.NEG2).float()
    te = lens.long().clamp(1, T)
    init = torch.where(torch.arange(S)[None] < 2, lp2[:, 0], C.NEG2)
    alpha, off = C._chain(lp2, skip2, init, te, beta=False)
    frames = torch.arange(T)[None, :, None] < te[:, None, None]
    top = torch.where(frames, alpha, -float("inf")).amax(-1)
    ok = top[torch.arange(T)[None] < te[:, None]]
    assert float(ok.max()) <= 4.0 and float(ok.min()) >= -128.0
    assert float(off.abs().max()) > 3e3
