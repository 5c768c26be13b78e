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


def test_infeasible_alignment_follows_the_pallas_kernel():
    """More labels than the frames allow: the port follows the Pallas
    kernel (-1e30 for -inf: a loss near 1e30, finite, no NaN in loss or
    grad), not optax's log_epsilon (~1e5)."""
    logits, _, labels, label_lens = _case(8, 2, 12, 9, 8, min_label=8)
    logit_lens = np.asarray([12, 5], np.int32)   # row 1: 8 labels, 5 frames
    w = np.ones(2, np.float32)
    got, g_got = _plain_loss_and_grad(logits, logit_lens, labels, label_lens,
                                      w)
    want, _ = _jax_loss_and_grad(
        lambda *a: M.ctc_loss_pallas(*a, blank_id=0, interpret=True),
        logits, logit_lens, labels, label_lens, w)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[1] > 1e29 and got[0] < 1e3 and np.isfinite(got).all()
    assert np.isfinite(g_got).all()


def test_cpu_route_launches_nothing():
    before = C.ctc_loss.launches
    args = _case(9, 2, 20, 7, 4)
    C.ctc_loss(*(torch.from_numpy(a) for a in args))
    assert C.ctc_loss.launches == before
