"""CTC loss: the Hopper kernel and its plain twin.

Port of masr_tpu/ops/pallas/ctc_loss.py (`ctc_loss`, `ctc_loss_pallas`):
the per-sequence negative log-likelihood of right-padded logits (B, T, V)
and labels (B, L) over blank-interleaved states with the repeated-label
skip rule, optax.ctc_loss's semantics. The CUDA source is
masr_tpu_torch/csrc/ctc_loss.cu; its header says how it is split into
kernels and what bounds it.

`ctc_loss` runs a `torch.autograd.Function` for a CUDA tensor (forward:
the row log-sum-exps and state log-probs, then the alpha and, when a grad
is wanted, the beta recursion side by side; backward: one pass over the
grad rows with the occupancies formed in place). There is no cap on the
number of states and no fallback. A CPU tensor takes `ctc_loss_plain`, a
readable log-space alpha recursion whose backward is autograd. Both use
-1e30 for -inf as the Pallas kernel does: on a batch whose alignment is
infeasible (more labels than frames allow) the loss is ~1e30 and finite,
where optax.ctc_loss's log_epsilon gives ~1e5.

`ctc_scheme_mirror` repeats the kernel's arithmetic (f32 in log2 units
relative to f64 offsets, the grouped scatter of `token_groups`) in plain
PyTorch, for the CPU tests of its precision (tests/test_torch_ctc_scheme.py);
nothing else calls it.

Launches: `ctc_loss.launches` counts one per forward and one per backward
call on a CUDA tensor (`.backward_launches` the backward ones).
"""
import ctypes
import functools
import math

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


LOG2E = 1.4426950408889634
NEG2 = NEG * LOG2E       # -1e30 in log2 units, the kernel's kNeg2


def _lse3_2(a, b, c):
    """log2(2^a + 2^b + 2^c) as the kernel takes it: the largest term is
    1, the other two are 2^(lo - hi)."""
    hi1, lo1 = torch.maximum(a, b), torch.minimum(a, b)
    hi, lo2 = torch.maximum(hi1, c), torch.minimum(hi1, c)
    return hi + torch.log2(1.0 + torch.exp2(lo1 - hi) + torch.exp2(lo2 - hi))


def _chain(lp2, skip2, init, frames, beta):
    """One direction of the kernel's recursion for the batch, f32 in log2
    units relative to per-sequence f64 offsets: step k shifts the values by
    r_k = M_{k-2} - r_{k-1} (M_j the max of step j's stored values; r_1 =
    0), so the offset is the true max of step k-2. lp2 (B, T, S); skip2
    (B, S) additive (beta: the skip into s + 2); init (B, S) step 0;
    frames (B,) steps + 1 of each chain (alpha: frames 0..frames-1, beta:
    frames-1..0). → values (B, T, S) f32 and offsets (B, T) f64, frames
    outside the chain left at NEG2 / 0."""
    B, T, S = lp2.shape
    dev = lp2.device
    vals = torch.full((B, T, S), NEG2, dtype=torch.float32, device=dev)
    offs = torch.zeros(B, T, dtype=torch.float64, device=dev)
    bi = torch.arange(B, device=dev)
    neg = torch.full((B, 2), NEG2, dtype=torch.float32, device=dev)
    f0 = (frames - 1).clamp(min=0) if beta else torch.zeros_like(frames)
    live = frames > 0
    v = init
    vals[bi[live], f0[live]] = v[live]
    o = torch.zeros(B, dtype=torch.float64, device=dev)
    r_prev = torch.zeros(B, dtype=torch.float32, device=dev)
    m_prev = torch.zeros(B, dtype=torch.float32, device=dev)
    for k in range(1, T):
        act = k < frames
        if not bool(act.any()):
            break
        r = (m_prev - r_prev) if k >= 2 else torch.zeros_like(r_prev)
        pm = v.max(dim=1).values
        if beta:
            f = (frames - 1 - k).clamp(min=0)
            lp = lp2[bi, (f + 1).clamp(max=T - 1)]
            z = v + lp
            zn = torch.cat([z, neg], dim=1)
            new = _lse3_2(zn[:, :S], zn[:, 1:S + 1], zn[:, 2:] + skip2) \
                - r[:, None]
        else:
            f = torch.full_like(frames, k)
            vn = torch.cat([neg, v], dim=1)
            new = _lse3_2(vn[:, 2:], vn[:, 1:S + 1], vn[:, :S] + skip2) \
                + lp2[:, k] - r[:, None]
        v = torch.where(act[:, None], new, v)
        o = torch.where(act, o + r.double(), o)
        vals[bi[act], f[act]] = v[act]
        offs[bi[act], f[act]] = o[act]
        m_prev = torch.where(act, pm, m_prev)
        r_prev = torch.where(act, r, r_prev)
    return vals, offs


def token_groups(labels, label_lens, blank=0):
    """The kernel's per-sequence scatter table: the states s < n grouped by
    token, groups in order of their first state, s order inside a group.
    → list over the batch of [(token, [states])]."""
    out = []
    for lab, ln in zip(labels.tolist(), label_lens.tolist()):
        groups = {}
        for s in range(2 * int(ln) + 1):
            tok = lab[(s - 1) // 2] if s % 2 else blank
            groups.setdefault(tok, []).append(s)
        out.append(list(groups.items()))
    return out


def ctc_scheme_mirror(logits, logit_lens, labels, label_lens, gout,
                      blank=0):
    """The CUDA kernel's numerical scheme in plain PyTorch (tests only):
    the state log-probs in log2 units, the alpha and beta recursions in f32
    relative to f64 offsets (`_chain`), log Z in f64, the occupancies
    2^min(alpha + beta + (offsets - log Z), 0) in f32, and the grad row
    g * (softmax * occupancy - the groups' sums in s order). Frames at or
    past tlen have no occupancy (the Pallas kernel's beta), nor have any
    when tlen is not in [1, T]. → nll (B,) f32, grad (B, T, V) f32."""
    B, T, V = logits.shape
    dev = logits.device
    labels = labels.long().clamp(min=0)
    states, valid, skip, n = _states(labels, label_lens, blank)
    S = states.shape[1]
    x = logits.float()
    lse = torch.logsumexp(x, dim=-1)
    lp2 = torch.where(valid[:, None, :], (x.gather(
        2, states[:, None, :].expand(B, T, S)) - lse[..., None]) * LOG2E,
        NEG2).float()
    skip2 = torch.where(skip == 0, 0.0, NEG2).float()
    tlen = logit_lens.to(dev).long()
    s_idx = torch.arange(S, device=dev)
    # alpha: frames 0 .. te-1
    te = tlen.clamp(1, T)
    a_init = torch.where(s_idx[None] < 2, lp2[:, 0], NEG2)
    alpha, off_a = _chain(lp2, skip2, a_init, te, beta=False)
    bi = torch.arange(B, device=dev)
    last = alpha[bi, te - 1].double()
    a1 = last.gather(1, (n - 1)[:, None])[:, 0]
    a2 = torch.where(n >= 2, last.gather(
        1, (n - 2).clamp(min=0)[:, None])[:, 0], NEG2)
    hi, lo = torch.maximum(a1, a2), torch.minimum(a1, a2)
    logz = off_a[bi, te - 1] + hi + torch.log2(1.0 + torch.exp2(lo - hi))
    nll = (-logz * math.log(2.0)).float()
    # beta: frames tb-1 .. 0
    tb = torch.where((tlen >= 1) & (tlen <= T), tlen, 0)
    term = (s_idx[None] == (n - 1)[:, None]) | (
        (s_idx[None] == (n - 2)[:, None]) & (n >= 2)[:, None])
    skip_b = torch.cat([skip2[:, 2:], torch.full((B, 2), NEG2, device=dev)],
                       dim=1)
    beta, off_b = _chain(lp2, skip_b, torch.where(term, 0.0, NEG2).float(),
                         tb, beta=True)
    c = (off_a + off_b - logz[:, None]).float()
    gam = torch.exp2(torch.clamp(alpha + beta + c[..., None], max=0.0))
    gam = torch.where(valid[:, None, :] & (
        torch.arange(T, device=dev)[None, :, None] < tb[:, None, None]),
        gam, 0.0)
    occ = gam.sum(-1)
    g = gout.to(dev).float()
    grad = g[:, None, None] * (torch.exp(x - lse[..., None]) * occ[..., None])
    for b, groups in enumerate(token_groups(labels, label_lens, blank)):
        rows = gam[b]
        for tok, sts in groups:
            tot = rows[:, sts[0]].clone()
            for s in sts[1:]:
                tot = tot + rows[:, s]
            grad[b, :, tok] = g[b] * (torch.exp(x[b, :, tok] - lse[b]) *
                                      occ[b] - tot)
    return nll, grad


@functools.lru_cache(maxsize=None)
def _lib():
    from masr_tpu_torch.ops.cuda import build
    lib = build.load("ctc_loss")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.masr_ctc_scratch_bytes.restype = ctypes.c_longlong
    lib.masr_ctc_scratch_bytes.argtypes = [I] * 3
    lib.masr_ctc_forward.restype = I
    lib.masr_ctc_forward.argtypes = [P] * 6 + [I] * 6 + [P]
    lib.masr_ctc_backward.restype = I
    lib.masr_ctc_backward.argtypes = [P] * 7 + [I] * 5 + [P]
    return lib


@functools.lru_cache(maxsize=None)
def _scratch_bytes(B, T, L):
    return _lib().masr_ctc_scratch_bytes(B, T, L)


class _CTC(torch.autograd.Function):
    @staticmethod
    def forward(ctx, blank, need_grad, logits, logit_lens, labels,
                label_lens):
        lib = _lib()
        B, T, V = logits.shape
        L = labels.shape[1]
        nll = torch.empty(B, dtype=torch.float32, device=logits.device)
        scratch = torch.empty(_scratch_bytes(B, T, L),
                              dtype=torch.uint8, device=logits.device)
        with torch.cuda.device(logits.device):
            err = lib.masr_ctc_forward(
                logits.data_ptr(), labels.data_ptr(), logit_lens.data_ptr(),
                label_lens.data_ptr(), nll.data_ptr(), scratch.data_ptr(),
                B, T, V, L, blank, int(need_grad),
                torch.cuda.current_stream(logits.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"ctc_loss forward kernel failed: CUDA error "
                               f"{err}")
        ctc_loss.launches += 1
        ctx.blank = blank
        if need_grad:
            ctx.save_for_backward(logits, logit_lens, labels, label_lens,
                                  scratch)
        return nll

    @staticmethod
    def backward(ctx, gout):
        lib = _lib()
        logits, logit_lens, labels, label_lens, scratch = ctx.saved_tensors
        B, T, V = logits.shape
        L = labels.shape[1]
        gout = gout.contiguous().float()
        grad = torch.empty_like(logits)
        with torch.cuda.device(logits.device):
            err = lib.masr_ctc_backward(
                logits.data_ptr(), labels.data_ptr(), logit_lens.data_ptr(),
                label_lens.data_ptr(), scratch.data_ptr(), gout.data_ptr(),
                grad.data_ptr(), B, T, V, L, ctx.blank,
                torch.cuda.current_stream(logits.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"ctc_loss backward kernel failed: CUDA "
                               f"error {err}")
        ctc_loss.launches += 1
        ctc_loss.backward_launches += 1
        return None, None, grad, None, None, None


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
    dev = logits.device

    def i32(t, shape, name):
        t = t.to(dev, torch.int32).contiguous()
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shape}")
        return t

    L = labels.shape[1]
    # the beta chains and the group tables only where a grad can follow
    need_grad = torch.is_grad_enabled() and logits.requires_grad
    return _CTC.apply(int(blank), need_grad, logits.contiguous(),
                      i32(logit_lens, (B,), "logit_lens"),
                      i32(labels, (B, L), "labels"),
                      i32(label_lens, (B,), "label_lens"))


ctc_loss.launches = 0
ctc_loss.backward_launches = 0
