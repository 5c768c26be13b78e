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
readable log-space alpha recursion whose backward is autograd.

Both follow optax.ctc_loss, masr_tpu's CPU route (the Pallas kernel's
header promises its semantics), on every alignment. optax stands for
log(0) by log_epsilon = -1e5 in its initial rows (every state but the
first starts at -1e5) and in the skip between two equal labels; -1e30
bars the rest (states past 2 * label_len, even states' skips). So an
alignment that needs more frames than it has costs 1e5 for each such
step and stays finite: 1e5 x (the fewest of them) + the cost of the
paths that take that fewest. Since one step off the start reaches any
state, the fewest is 0 (a feasible alignment) or 1 (an infeasible one,
or tlen = 0 with labels). Both versions count these steps exactly: each
state holds (class, log-prob), the class the least number of -1e5 steps
of the paths into it and the log-prob the sum over those paths only
(optax's other paths weigh exp(-1e5) less: 0 in f32 and f64). The
1e5 x class is added once, at the end, so the paths' costs keep their
precision (optax's f32 recursion rounds them to 2^-7 at -1e5). A frame
count of 0 reads the rows before frame 0: loss 0 for an empty label,
1e5 - ln 2 otherwise, and no grad.

The kernel carries the classes only in rows that need them (tlen = 0, or
fewer frames than the labels and the blanks between equal neighbours
take: `needs_classes`); a feasible row's log Z is of class 0, the class-1
terms its classes would drop weigh nothing beside it, and its chains run
with -1e30 for every -1e5 step, at the cost they had before.

`ctc_scheme_mirror` repeats the kernel's arithmetic (f32 in log2 units
relative to f64 offsets, the grouped scatter of `token_groups`, the
classes where the kernel carries them, else the offsets from the max over
the live states of `live_steps`) in plain PyTorch, for the CPU tests of
its precision (tests/test_torch_ctc_scheme.py); nothing else calls it.

Launches: `ctc_loss.launches` counts one per forward and one per backward
call on a CUDA tensor (`.backward_launches` the backward ones).
"""
import ctypes
import functools
import math

import torch

NEG = -1.0e30
PENALTY = 1.0e5   # -log_epsilon of optax.ctc_loss
DEAD = 2          # a class no path of the least count can reach


def _states(labels, label_lens, blank):
    """→ states (B, S) token ids, valid (B, S), skip (B, S) int: the -1e5
    steps the skip s-2 → s takes (0: a new label, 1: the same label as
    before it, DEAD: barred), n_states (B,)."""
    B, L = labels.shape
    S = 2 * L + 1
    s = torch.arange(S, device=labels.device)
    lab_idx = torch.clamp((s - 1) // 2, min=0)
    lab = labels.gather(1, lab_idx.expand(B, S))
    prev = labels.gather(1, torch.clamp(lab_idx - 1, min=0).expand(B, S))
    states = torch.where(s % 2 == 1, lab, blank)
    n_states = 2 * label_lens.to(labels.device).long() + 1
    valid = s[None, :] < n_states[:, None]
    skip_ok = (s % 2 == 1) & (s >= 3) & valid
    skip = torch.where(skip_ok, (lab == prev).long(), DEAD)
    return states.where(valid, blank), valid, skip, n_states


def needs_classes(labels, label_lens, logit_lens, T):
    """(B,) bool: the rows whose chains the kernel runs with classes: no
    frame, or min(tlen, T) below the labels plus the labels equal to the
    one before (every path then takes a -1e5 step). labels (B, L) clamped
    to >= 0."""
    nlab = label_lens.to(labels.device).long()
    cols = torch.arange(1, labels.shape[1], device=labels.device)
    repeats = ((labels[:, 1:] == labels[:, :-1])
               & (cols[None, :] < nlab[:, None])).sum(dim=1)
    tlen = logit_lens.to(labels.device).long()
    return (tlen <= 0) | (tlen.clamp(max=T) < nlab + repeats)


def _start_classes(valid):
    """The rows before frame 0 (optax's initial rows): state 0 at class 0,
    every other state of the sequence at class 1, log-prob 0."""
    s = torch.arange(valid.shape[1], device=valid.device)
    return torch.where(valid, (s > 0).long()[None, :], DEAD)


def _logaddexp3(a, b, c):
    m = torch.maximum(torch.maximum(a, b), c)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m)
                         + torch.exp(c - m))


def _least(neg, *terms):
    """(class, value) terms → the least class and the values of the terms
    of that class (the others at `neg`)."""
    cm = terms[0][0]
    for c, _ in terms[1:]:
        cm = torch.minimum(cm, c)
    return cm, [torch.where(c == cm, v, neg) for c, v in terms]


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
    # one (B, S) view a frame: indexing lp[:, t] in the loop would make
    # autograd add T zero-padded (B, T, S) grads, O(T^2 S)
    lp = torch.where(valid[:, None, :],
                     logp.gather(2, states[:, None, :].expand(B, T, S)),
                     NEG).unbind(1)
    tlen = logit_lens.to(logits.device).long()
    dev = logits.device
    neg = torch.full((B, 2), NEG, device=dev, dtype=x.dtype)
    dead = torch.full((B, 2), DEAD, device=dev, dtype=torch.long)
    cls = _start_classes(valid)
    alpha = torch.zeros(B, S, device=dev, dtype=x.dtype)
    for t in range(T):
        c1 = torch.cat([dead[:, :1], cls[:, :-1]], dim=1)
        a1 = torch.cat([neg[:, :1], alpha[:, :-1]], dim=1)
        c2 = torch.cat([dead, cls], dim=1)[:, :S] + skip
        a2 = torch.cat([neg, alpha], dim=1)[:, :S]
        cm, vs = _least(NEG, (cls, alpha), (c1, a1), (c2, a2))
        new = _logaddexp3(*vs) + lp[t]
        on = (t < tlen)[:, None]
        alpha = torch.where(on, new, alpha)
        cls = torch.where(on, torch.where(valid, cm.clamp(max=DEAD), DEAD),
                          cls)
    i1, i2 = (n - 1)[:, None], torch.clamp(n - 2, min=0)[:, None]
    k, (v1, v2) = _least(
        NEG, (cls.gather(1, i1)[:, 0], alpha.gather(1, i1)[:, 0]),
        (torch.where(n >= 2, cls.gather(1, i2)[:, 0], DEAD),
         alpha.gather(1, i2)[:, 0]))
    return k.to(x.dtype) * PENALTY - torch.logaddexp(v1, v2)


LOG2E = 1.4426950408889634
NEG2 = NEG * LOG2E       # -1e30 in log2 units, the kernel's kNeg2


def _lse3_2(a, b, c):
    """log2(2^a + 2^b + 2^c) as the kernel takes it: the largest term is
    1, the other two are 2^(lo - hi)."""
    hi1, lo1 = torch.maximum(a, b), torch.minimum(a, b)
    hi, lo2 = torch.maximum(hi1, c), torch.minimum(hi1, c)
    return hi + torch.log2(1.0 + torch.exp2(lo1 - hi) + torch.exp2(lo2 - hi))


def live_steps(labels, label_lens, frames, beta):
    """(B, S) long: the last step of a class-free chain at which each state
    is live, -1 past the sequence. Alpha (step k = frame k of frames): the
    state can still reach a final state (n - 1 or n - 2) by frame
    frames - 1, i.e. k + its fewest steps to one <= frames - 1. Beta (step
    k = frame frames - 1 - k): the start reaches the state by its frame,
    i.e. its fewest frames from frame 0 <= frames - 1 - k. Both come from
    R_i, the labels equal to the one before among labels 1 .. i: label i
    is first reached at frame i + R_i and the blank before it at
    i + R_i - [label i repeats]; from label i the last label is
    L' - 1 - i + R - R_i steps away and from the blank before it one
    more (L' the label length, R its repeats). A dead state feeds only dead
    states and a live one only live ones (barred skips aside), so a live
    state's value is untouched by the dead ones. labels (B, L) clamped to
    >= 0; frames (B,)."""
    B, L = labels.shape
    S = 2 * L + 1
    dev = labels.device
    nlab = label_lens.to(dev).long()
    i = torch.arange(L, device=dev)
    rep = torch.zeros(B, L, dtype=torch.long, device=dev)
    rep[:, 1:] = ((labels[:, 1:] == labels[:, :-1])
                  & (i[None, 1:] < nlab[:, None])).long()
    pre = rep.cumsum(dim=1)
    tot = pre[:, -1] if L else torch.zeros(B, dtype=torch.long, device=dev)
    if beta:
        d_lab, d_blank, d_end = i + pre, i + pre - rep, nlab + tot
    else:
        d_lab = (nlab[:, None] - 1 - i) + (tot[:, None] - pre)
        d_blank, d_end = d_lab + 1, torch.zeros_like(nlab)
    d = torch.empty(B, S, dtype=torch.long, device=dev)
    d[:, 1::2], d[:, 0:2 * L:2] = d_lab, d_blank
    s = torch.arange(S, device=dev)
    d = torch.where(s[None] == 2 * nlab[:, None], d_end[:, None], d)
    last = frames.to(dev).long()[:, None] - 1 - d
    return torch.where(s[None] <= 2 * nlab[:, None], last, -1)


def _chain(lp2, skip2, init, frames, beta, cls=None, last=None):
    """One direction of the kernel's recursion for the batch, f32 in log2
    units relative to per-sequence f64 offsets: step k shifts the values by
    r_k = M_{k-2} - r_{k-1} (M_j the max of step j's stored values; r_1 =
    0), so the offset is the true max of step k-2. lp2 (B, T, S); init (B,
    S) step 0; frames (B,) steps + 1 of each chain (alpha: frames
    0..frames-1, beta: frames-1..0). Without `cls`, skip2 (B, S) is
    additive (beta: the skip into s + 2) and every state is of one class →
    values (B, T, S) f32 and offsets (B, T) f64, frames outside the chain
    left at NEG2 / 0. With cls = (init classes, skip classes (as skip2),
    valid), each state also carries its class (`ctc_loss_plain`), a term
    of a higher class than the least of its three drops out, a state past
    the sequence or of class DEAD holds NEG2, and the classes (B, T, S)
    come back third. With `last` (`live_steps`), M_j is the max over the
    states live at step j only."""
    B, T, S = lp2.shape
    dev = lp2.device
    vals = torch.full((B, T, S), NEG2, dtype=torch.float32, device=dev)
    offs = torch.zeros(B, T, dtype=torch.float64, device=dev)
    bi = torch.arange(B, device=dev)
    neg = torch.full((B, 2), NEG2, dtype=torch.float32, device=dev)
    if cls is None:
        c, skip_c, valid = torch.zeros(B, S, dtype=torch.long, device=dev), \
            torch.zeros(B, S, dtype=torch.long, device=dev), None
    else:
        c, skip_c, valid = cls
        skip2 = torch.zeros_like(skip2)
    clss = torch.full((B, T, S), DEAD, dtype=torch.long, device=dev)
    dead = torch.full((B, 2), DEAD, dtype=torch.long, device=dev)
    f0 = (frames - 1).clamp(min=0) if beta else torch.zeros_like(frames)
    live = frames > 0
    v = init
    vals[bi[live], f0[live]] = v[live]
    clss[bi[live], f0[live]] = c[live]
    o = torch.zeros(B, dtype=torch.float64, device=dev)
    r_prev = torch.zeros(B, dtype=torch.float32, device=dev)
    m_prev = torch.zeros(B, dtype=torch.float32, device=dev)
    for k in range(1, T):
        act = k < frames
        if not bool(act.any()):
            break
        r = (m_prev - r_prev) if k >= 2 else torch.zeros_like(r_prev)
        pm = (v if last is None else torch.where(k - 1 <= last, v, NEG2)
              ).max(dim=1).values
        if beta:
            f = (frames - 1 - k).clamp(min=0)
            lp = lp2[bi, (f + 1).clamp(max=T - 1)]
            zn = torch.cat([v + lp, neg], dim=1)
            cn = torch.cat([c, dead], dim=1)
            terms = ((cn[:, :S], zn[:, :S]), (cn[:, 1:S + 1], zn[:, 1:S + 1]),
                     (cn[:, 2:] + skip_c, zn[:, 2:] + skip2))
            cm, vs = _least(NEG2, *terms)
            new = _lse3_2(*vs) - r[:, None]
        else:
            f = torch.full_like(frames, k)
            vn = torch.cat([neg, v], dim=1)
            cn = torch.cat([dead, c], dim=1)
            terms = ((cn[:, 2:], vn[:, 2:]), (cn[:, 1:S + 1], vn[:, 1:S + 1]),
                     (cn[:, :S] + skip_c, vn[:, :S] + skip2))
            cm, vs = _least(NEG2, *terms)
            new = _lse3_2(*vs) + lp2[:, k] - r[:, None]
        if valid is not None:
            live_s = valid & (cm < DEAD)
            new = torch.where(live_s, new, NEG2)
            cm = torch.where(live_s, cm, DEAD)
        v = torch.where(act[:, None], new, v)
        c = torch.where(act[:, None], cm, c)
        o = torch.where(act, o + r.double(), o)
        vals[bi[act], f[act]] = v[act]
        clss[bi[act], f[act]] = c[act]
        offs[bi[act], f[act]] = o[act]
        m_prev = torch.where(act, pm, m_prev)
        r_prev = torch.where(act, r, r_prev)
    if cls is None:
        return vals, offs
    return vals, offs, clss


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
    relative to f64 offsets with each state's class (`_chain`), log Z in
    f64 with the class of its paths, the occupancies 2^min(alpha + beta +
    (offsets - log Z), 0) in f32 of the states whose alpha and beta
    classes add up to log Z's, and the grad row g * (softmax * occupancy -
    the groups' sums in s order). The rows that do not `needs_classes` run
    without classes (every state of class 0, -1e30 for each -1e5 step), as
    the kernel runs them. Frames at or past tlen have no occupancy, nor
    have any when tlen is not in [1, T]; tlen = 0 reads the rows before
    frame 0. → nll (B,) f32, grad (B, T, V) f32."""
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
    zero2 = torch.zeros(B, S, dtype=torch.float32, device=dev)
    tlen = logit_lens.to(dev).long()
    s_idx = torch.arange(S, device=dev)
    # alpha: frames 0 .. te-1, frame 0 one step from the rows before it
    te = tlen.clamp(1, T)
    c0 = _start_classes(valid)
    dead = torch.full((B, 2), DEAD, dtype=torch.long, device=dev)
    cn = torch.cat([dead, c0], dim=1)
    vn = torch.cat([torch.full((B, 2), NEG2, device=dev),
                    torch.where(valid, 0.0, NEG2)], dim=1).float()
    cm, vs = _least(NEG2, (cn[:, 2:], vn[:, 2:]),
                    (cn[:, 1:S + 1], vn[:, 1:S + 1]),
                    (cn[:, :S] + skip, vn[:, :S]))
    a_init = torch.where(valid, _lse3_2(*vs) + lp2[:, 0], NEG2)
    alpha, off_a, cls_a = _chain(lp2, zero2, a_init, te, beta=False,
                                 cls=(torch.where(valid, cm, DEAD), skip,
                                      valid))
    # the rows without classes: class 0, -1e30 for each -1e5 step
    plain = ~needs_classes(labels, label_lens, tlen, T)
    skip2 = torch.where(skip == 0, 0.0, NEG2).float()
    if bool(plain.any()):
        p_alpha, p_off = _chain(
            lp2, skip2, torch.where(s_idx[None] < 2, lp2[:, 0], NEG2), te,
            beta=False, last=live_steps(labels, label_lens, te, beta=False))
        alpha = torch.where(plain[:, None, None], p_alpha, alpha)
        off_a = torch.where(plain[:, None], p_off, off_a)
        cls_a = torch.where(plain[:, None, None], 0, cls_a)
    bi = torch.arange(B, device=dev)
    last, lastc = alpha[bi, te - 1].double(), cls_a[bi, te - 1]
    i1, i2 = (n - 1)[:, None], (n - 2).clamp(min=0)[:, None]
    kz, (a1, a2) = _least(
        NEG2, (lastc.gather(1, i1)[:, 0], last.gather(1, i1)[:, 0]),
        (torch.where(n >= 2, lastc.gather(1, i2)[:, 0], DEAD),
         last.gather(1, i2)[:, 0]))
    hi, lo = torch.maximum(a1, a2), torch.minimum(a1, a2)
    logz = off_a[bi, te - 1] + hi + torch.log2(1.0 + torch.exp2(lo - hi))
    # no frame: the rows before frame 0 (state n - 1 and n - 2 at class 1)
    zero = tlen <= 0
    kz = torch.where(zero, (n >= 2).long(), kz)
    logz = torch.where(zero, (n >= 2).double(), logz)
    nll = (kz.double() * PENALTY - logz * math.log(2.0)).float()
    # beta: frames tb-1 .. 0
    tb = torch.where((tlen >= 1) & (tlen <= T), tlen, 0)
    term = (s_idx[None] == (n - 1)[:, None]) | (
        (s_idx[None] == (n - 2)[:, None]) & (n >= 2)[:, None])
    skip_b = torch.cat([skip[:, 2:], dead], dim=1)
    beta, off_b, cls_b = _chain(
        lp2, zero2, torch.where(term, 0.0, NEG2).float(), tb, beta=True,
        cls=(torch.where(term, 0, DEAD), skip_b, valid))
    if bool(plain.any()):
        p_beta, p_off = _chain(
            lp2, torch.cat([skip2[:, 2:], torch.full((B, 2), NEG2,
                                                      device=dev)], dim=1),
            torch.where(term, 0.0, NEG2).float(), tb, beta=True,
            last=live_steps(labels, label_lens, tb, beta=True))
        beta = torch.where(plain[:, None, None], p_beta, beta)
        off_b = torch.where(plain[:, None], p_off, off_b)
        cls_b = torch.where(plain[:, None, None], 0, cls_b)
    c = (off_a + off_b - logz[:, None]).float()
    gam = torch.exp2(torch.clamp(alpha + beta + c[..., None], max=0.0))
    gam = torch.where(valid[:, None, :] & (cls_a + cls_b == kz[:, None, None])
                      & (torch.arange(T, device=dev)[None, :, None]
                         < tb[:, None, None]), gam, 0.0)
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
