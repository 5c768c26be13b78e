"""The port's CTC loss (masr_tpu_torch/ops/cuda/ctc_loss.py) against
masr_tpu: the plain twin and its autograd grads against optax.ctc_loss and
against the Pallas kernel in interpret mode, and against
torch.nn.functional.ctc_loss. The CUDA kernel is held against the plain
twin in tests/test_torch_cuda_kernels.py."""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
import torch.nn.functional as F

from masr_tpu.ops.pallas import ctc_loss as M
from masr_tpu_torch.ops.cuda import ctc_loss as C
from test_torch_threads import one_torch_thread  # noqa: F401


def _case(seed, B, T, V, L, repeats=False, min_label=1):
    """Random padded batch; every alignment feasible (tlen >= 2L + 1)."""
    rs = np.random.RandomState(seed)
    logits = (rs.standard_normal((B, T, V)) * 2.0).astype(np.float32)
    labels = rs.randint(1, 4 if repeats else V, (B, L)).astype(np.int32)
    label_lens = rs.randint(min_label, L + 1, (B,)).astype(np.int32)
    logit_lens = rs.randint(min(2 * L + 1, T), T + 1, (B,)).astype(np.int32)
    labels[np.arange(L)[None] >= label_lens[:, None]] = -1
    return logits, logit_lens, labels, label_lens


def _pads(logit_lens, label_lens, T, L):
    return ((np.arange(T)[None] >= logit_lens[:, None]).astype(np.float32),
            (np.arange(L)[None] >= label_lens[:, None]).astype(np.float32))


def _jax_loss_and_grad(fn, logits, logit_lens, labels, label_lens, w):
    B, T, _ = logits.shape
    L = labels.shape[1]
    lpad, ypad = _pads(logit_lens, label_lens, T, L)
    lab = jnp.asarray(np.where(labels < 0, 0, labels))

    def total(lg):
        nll = fn(lg, jnp.asarray(lpad), lab, jnp.asarray(ypad))
        return jnp.sum(nll * w), nll

    (_, nll), g = jax.jit(jax.value_and_grad(total, has_aux=True))(
        jnp.asarray(logits))
    return np.asarray(nll), np.asarray(g)


def _plain_loss_and_grad(logits, logit_lens, labels, label_lens, w):
    lg = torch.from_numpy(logits).requires_grad_(True)
    nll = C.ctc_loss(lg, torch.from_numpy(logit_lens),
                     torch.from_numpy(labels), torch.from_numpy(label_lens))
    (nll * torch.from_numpy(w)).sum().backward()
    return nll.detach().numpy(), lg.grad.numpy()


CASES = [(0, 4, 37, 23, 9, False), (1, 4, 37, 23, 9, True),
         (3, 3, 25, 17, 5, False), (4, 2, 21, 11, 10, True)]


@pytest.mark.parametrize("seed,B,T,V,L,repeats", CASES)
def test_plain_matches_optax_and_pallas(seed, B, T, V, L, repeats):
    """Plain twin == optax.ctc_loss and == ctc_loss_pallas(interpret):
    losses rtol = atol = 1e-5, grads of a weighted sum rtol 2e-4 atol 2e-5
    (the Pallas test's own tolerances); padded labels, repeats, T near the
    2L + 1 minimum."""
    args = _case(seed, B, T, V, L, repeats)
    w = np.random.RandomState(seed + 100).standard_normal(B).astype(
        np.float32)
    got, g_got = _plain_loss_and_grad(*args, w)
    for fn in (lambda *a: optax.ctc_loss(*a, blank_id=0),
               lambda *a: M.ctc_loss_pallas(*a, blank_id=0, interpret=True)):
        want, g_want = _jax_loss_and_grad(fn, *args, w)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g_got, g_want, rtol=2e-4, atol=2e-5)


def test_long_labels_past_the_tpu_state_cap():
    """S = 2L + 1 = 141 > 128 (the Pallas kernel's lane cap, where masr_tpu
    falls back to optax): the plain twin == optax, same tolerances."""
    args = _case(5, 2, 150, 13, 70, min_label=64)
    w = np.ones(2, np.float32)
    got, g_got = _plain_loss_and_grad(*args, w)
    want, g_want = _jax_loss_and_grad(
        lambda *a: optax.ctc_loss(*a, blank_id=0), *args, w)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(g_got, g_want, rtol=2e-4, atol=2e-5)


def test_empty_label_and_torch_ctc():
    """label_len 0 (S = 1, all blank) and the rest of the batch == torch's
    F.ctc_loss(reduction='none') on log_softmax, rtol 1e-5 atol 1e-4."""
    logits, logit_lens, labels, label_lens = _case(6, 3, 30, 19, 6)
    labels[1] = -1
    label_lens[1] = 0
    got = C.ctc_loss(torch.from_numpy(logits), torch.from_numpy(logit_lens),
                     torch.from_numpy(labels), torch.from_numpy(label_lens))
    lp = torch.log_softmax(torch.from_numpy(logits), -1).transpose(0, 1)
    want = F.ctc_loss(lp, torch.from_numpy(np.where(labels < 0, 0, labels)),
                      torch.from_numpy(logit_lens).long(),
                      torch.from_numpy(label_lens).long(), blank=0,
                      reduction="none")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-4)
    assert np.isfinite(got.numpy()).all()


def _mixed_case(name):
    """Batches that mix feasible and infeasible alignments: → (logits,
    logit_lens, labels, label_lens). "probe": 6 labels over 4 frames
    beside a feasible row; "mixed": repeated labels, an empty label, a
    frame count of 0 with and without labels; "long": S = 141 > 128 with
    one row 20 frames short."""
    if name == "probe":
        logits, _, labels, label_lens = _case(8, 2, 8, 7, 6, min_label=6)
        label_lens[0] = 3
        labels[0, 3:] = -1
        return logits, np.asarray([8, 4], np.int32), labels, label_lens
    if name == "mixed":
        logits, _, labels, _ = _case(10, 6, 20, 9, 8, repeats=True)
        label_lens = np.asarray([8, 0, 6, 3, 0, 7], np.int32)
        labels[np.arange(8)[None] >= label_lens[:, None]] = -1
        return (logits, np.asarray([20, 3, 5, 0, 0, 9], np.int32), labels,
                label_lens)
    logits, _, labels, label_lens = _case(5, 2, 150, 13, 70, min_label=64)
    label_lens[:] = 70
    return logits, np.asarray([150, 50], np.int32), labels, label_lens


def _masr_ctc(args, w, x64):
    """masr_tpu's ctc_loss (optax on the CPU) → (nll, grad of the weighted
    sum), in f64 under jax.enable_x64 when x64."""
    logits, logit_lens, labels, label_lens = args
    B, T, _ = logits.shape
    L = labels.shape[1]
    lpad, ypad = _pads(logit_lens, label_lens, T, L)
    lab = np.where(labels < 0, 0, labels)
    with jax.enable_x64(x64):
        dt = jnp.float64 if x64 else jnp.float32

        def total(lg):
            nll = M.ctc_loss(lg, jnp.asarray(lpad, dt), jnp.asarray(lab),
                             jnp.asarray(ypad, dt), blank_id=0)
            return jnp.sum(nll * jnp.asarray(w, dt)), nll

        (_, nll), g = jax.value_and_grad(total, has_aux=True)(
            jnp.asarray(logits, dt))
        return np.asarray(nll, np.float64), np.asarray(g, np.float64)


@pytest.mark.parametrize("name", ["probe", "mixed", "long"])
def test_infeasible_alignment_follows_optax(name):
    """More labels than the frames allow: the port follows masr_tpu's CPU
    ctc_loss (optax, log_epsilon -1e5): a loss of 1e5 + the cost of the
    paths with one -1e5 step (~100003 for 6 labels over 4 frames), where the
    Pallas kernel's -1e30 gives ~1e30. Per-sequence NLL within rel 1e-6 of
    masr_tpu's in f32 and in f64; the grad of the batch mean within 1e-5
    of masr_tpu's in f64 (x64), and of its f32 grad on the feasible rows
    at test_plain_matches_optax's rtol 2e-4 atol 2e-5 (optax's own f32
    recursion rounds the infeasible rows' paths to 2^-7 at -1e5: its f32
    grad there is ~2e-3 off its f64 one)."""
    args = _mixed_case(name)
    B = args[0].shape[0]
    w = np.full(B, 1.0 / B, np.float32)
    got, g_got = _plain_loss_and_grad(*args, w)
    feasible = args[1] >= np.asarray([
        int(n) + sum(x == y for x, y in zip(lab[:n], lab[1:n]))
        for lab, n in zip(args[2].tolist(), args[3].tolist())])
    assert (~feasible).any() and feasible.any()
    for x64 in (False, True):
        want, g_want = _masr_ctc(args, w, x64)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        if x64:
            np.testing.assert_allclose(g_got, g_want, rtol=0, atol=1e-5)
        else:
            np.testing.assert_allclose(g_got[feasible], g_want[feasible],
                                       rtol=2e-4, atol=2e-5)
    assert (got[~feasible] > 9e4).all() and (got[~feasible] < 2e5).all()
    assert np.isfinite(g_got).all()


def test_cpu_route_launches_nothing():
    before = C.ctc_loss.launches
    args = _case(9, 2, 20, 7, 4)
    C.ctc_loss(*(torch.from_numpy(a) for a in args))
    assert C.ctc_loss.launches == before
