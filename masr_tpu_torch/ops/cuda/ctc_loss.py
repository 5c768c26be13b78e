"""CTC loss: the Hopper kernel and its plain twin.

Port of masr_tpu/ops/pallas/ctc_loss.py (`ctc_loss`, `ctc_loss_pallas`):
the per-sequence negative log-likelihood of right-padded logits (B, T, V)
and labels (B, L) over blank-interleaved states with the repeated-label
skip rule, optax.ctc_loss's semantics. The CUDA source is
masr_tpu_torch/csrc/ctc_loss.cu; its header says how it is split into
kernels and what bounds it.

`ctc_loss` runs a `torch.autograd.Function` for a CUDA tensor (forward:
log-softmax + state gather and the alpha recursion; backward: the beta /
occupancy recursion and the grad rows). There is no cap on the number of
states and no fallback. A CPU tensor takes `ctc_loss_plain`, a readable
log-space alpha recursion whose backward is autograd. Both use -1e30 for
-inf as the Pallas kernel does: on a batch whose alignment is infeasible
(more labels than frames allow) the loss is ~1e30 and finite, where
optax.ctc_loss's log_epsilon gives ~1e5.

Launches: `ctc_loss.launches` counts one per forward and one per backward
call on a CUDA tensor (`.backward_launches` the backward ones).
"""
import ctypes

import torch

NEG = -1.0e30


def _states(labels, label_lens, blank):
    """→ states (B, S) token ids, valid (B, S), skip (B, S) additive 0/NEG
    (the skip s-2 → s allowed), n_states (B,)."""
    B, L = labels.shape
    S = 2 * L + 1
    s = torch.arange(S, device=labels.device)
    lab_idx = torch.clamp((s - 1) // 2, min=0)
    lab = labels.gather(1, lab_idx.expand(B, S))
    prev = labels.gather(1, torch.clamp(lab_idx - 1, min=0).expand(B, S))
    states = torch.where(s % 2 == 1, lab, blank)
    n_states = 2 * label_lens.to(labels.device).long() + 1
    valid = s[None, :] < n_states[:, None]
    skip_ok = (s % 2 == 1) & (s >= 3) & (lab != prev) & valid
    skip = torch.where(skip_ok, 0.0, NEG)
    return states.where(valid, blank), valid, skip, n_states


def _logaddexp3(a, b, c):
    m = torch.maximum(torch.maximum(a, b), c)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m)
                         + torch.exp(c - m))


def ctc_loss_plain(logits, logit_lens, labels, label_lens, blank=0):
    """Plain PyTorch version of the kernel: logits (B, T, V) f32 (or f64,
    kept, for a reference), logit_lens (B,), labels (B, L) with ids in
    [0, V) in the first label_lens[b] columns, label_lens (B,) →
    per-sequence NLL (B,)."""
    B, T, _ = logits.shape
    states, valid, skip, n = _states(labels.long().clamp(min=0), label_lens,
                                     blank)
    S = states.shape[1]
    x = logits if logits.dtype == torch.float64 else logits.float()
    logp = torch.log_softmax(x, dim=-1)
    lp = torch.where(valid[:, None, :],
                     logp.gather(2, states[:, None, :].expand(B, T, S)), NEG)
    tlen = logit_lens.to(logits.device).long()
    neg = torch.full((B, 1), NEG, device=logits.device, dtype=x.dtype)
    alpha = lp[:, 0] + torch.where(torch.arange(S, device=logits.device) < 2,
                                   0.0, NEG)
    for t in range(1, T):
        a1 = torch.cat([neg, alpha[:, :-1]], dim=1)
        a2 = torch.cat([neg, neg, alpha[:, :-2]], dim=1)[:, :S] + skip
        new = _logaddexp3(alpha, a1, a2) + lp[:, t]
        alpha = torch.where((t < tlen)[:, None], new, alpha)
    a_last = alpha.gather(1, (n - 1)[:, None])[:, 0]
    a_prev = torch.where(n >= 2, alpha.gather(
        1, torch.clamp(n - 2, min=0)[:, None])[:, 0], NEG)
    return -torch.logaddexp(a_last, a_prev)


def _lib():
    from masr_tpu_torch.ops.cuda import build
    lib = build.load("ctc_loss")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.masr_ctc_forward.restype = I
    lib.masr_ctc_forward.argtypes = [P] * 9 + [I] * 5 + [P]
    lib.masr_ctc_backward.restype = I
    lib.masr_ctc_backward.argtypes = [P] * 11 + [I] * 5 + [P]
    return lib


class _CTC(torch.autograd.Function):
    @staticmethod
    def forward(ctx, blank, logits, logit_lens, labels, label_lens):
        lib = _lib()
        B, T, V = logits.shape
        L = labels.shape[1]
        S = 2 * L + 1
        f32 = dict(dtype=torch.float32, device=logits.device)
        f64 = dict(dtype=torch.float64, device=logits.device)
        nll, logz = torch.empty(B, **f32), torch.empty(B, **f64)
        lse, lp = torch.empty(B, T, **f32), torch.empty(B, T, S, **f32)
        alphas = torch.empty(B, T, S, **f64)
        with torch.cuda.device(logits.device):
            err = lib.masr_ctc_forward(
                logits.data_ptr(), labels.data_ptr(), logit_lens.data_ptr(),
                label_lens.data_ptr(), nll.data_ptr(), lse.data_ptr(),
                lp.data_ptr(), alphas.data_ptr(), logz.data_ptr(), B, T, V,
                L, blank, torch.cuda.current_stream(logits.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"ctc_loss forward kernel failed: CUDA error "
                               f"{err}")
        ctc_loss.launches += 1
        ctx.blank = blank
        ctx.save_for_backward(logits, logit_lens, labels, label_lens, lse,
                              lp, alphas, logz)
        return nll

    @staticmethod
    def backward(ctx, gout):
        lib = _lib()
        logits, logit_lens, labels, label_lens, lse, lp, alphas, logz = \
            ctx.saved_tensors
        B, T, V = logits.shape
        L = labels.shape[1]
        gout = gout.contiguous().float()
        gamma = torch.empty(alphas.shape, dtype=torch.float32,
                            device=alphas.device)
        grad = torch.empty_like(logits)
        with torch.cuda.device(logits.device):
            err = lib.masr_ctc_backward(
                logits.data_ptr(), labels.data_ptr(), logit_lens.data_ptr(),
                label_lens.data_ptr(), lse.data_ptr(), lp.data_ptr(),
                alphas.data_ptr(), logz.data_ptr(), gout.data_ptr(),
                gamma.data_ptr(), grad.data_ptr(), B, T, V, L, ctx.blank,
                torch.cuda.current_stream(logits.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"ctc_loss backward kernel failed: CUDA "
                               f"error {err}")
        ctc_loss.launches += 1
        ctc_loss.backward_launches += 1
        return None, grad, None, None, None


def ctc_loss(logits, logit_lens, labels, label_lens, blank=0):
    """Per-sequence CTC NLL (B,), differentiable in the logits. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernels or raises.
    logits (B, T, V) f32; logit_lens, label_lens (B,); labels (B, L) with
    ids in [0, V) in the first label_lens[b] columns (padding ignored)."""
    if logits.device.type == "cpu":
        return ctc_loss_plain(logits, logit_lens, labels, label_lens, blank)
    if logits.device.type != "cuda":
        raise ValueError(f"no kernel for device {logits.device}")
    B, T, V = logits.shape
    if logits.dtype != torch.float32:
        raise ValueError(f"logits must be f32, got {logits.dtype}")
    if V * 4 > 227 * 1024:
        raise ValueError(f"vocabulary {V}: the grad kernel holds one row of "
                         "V floats in shared memory (V <= 58112)")
    dev = logits.device

    def i32(t, shape, name):
        t = t.to(dev, torch.int32).contiguous()
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shape}")
        return t

    L = labels.shape[1]
    labels = i32(labels, (B, L), "labels").clamp(min=0)
    return _CTC.apply(int(blank), logits.contiguous(),
                      i32(logit_lens, (B,), "logit_lens"), labels,
                      i32(label_lens, (B,), "label_lens"))


ctc_loss.launches = 0
ctc_loss.backward_launches = 0
