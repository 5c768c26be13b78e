"""Batched CTC prefix beam search on the probs' device (port of
masr_tpu/decoders/device_beam.py: init_state :45, _segment_logsumexp :70,
beam_step :99, ctc_beam_search_jax :235, build_dense_bigram :264,
make_stream_decode_fn :299, DeviceBeamStream :350, decode_batch_device
:425).

masr_tpu runs this search as XLA programs (no Pallas kernel); the port runs
the same tensor program as PyTorch ops on whatever device the probs live
on, one frame at a time (a Python loop over frames in place of lax.scan).
The state never leaves that device inside the frame loop: one readback of
the best beams at the end.

The algorithm is the classic prefix beam search (the semantics of
beam_search._PyPrefixBeamSearch with cutoff_prob 1.0), vectorized:
 - beams hold (prefix tokens, p_blank, p_non_blank) per (batch, beam);
 - each frame proposes W stay candidates and W·K extensions (K =
   cutoff_top_n tokens of the frame);
 - equal prefixes among the candidates merge: a prefix is named by two
   rolling 32-bit hashes, kept in int64 tensors and reduced mod 2^32
   after every multiply-add (bit for bit masr_tpu's uint32 arithmetic);
   candidates are sorted by (h1, h2) with two stable sorts (h2, then h1)
   and a segment log-sum-exp merges each run of equal hashes;
 - the top W survive. Every top-k is a stable descending sort, sliced, so
   ties go to the lower index as lax.top_k gives them.
"""
import logging
import os

import numpy as np
import torch

logger = logging.getLogger("masr_tpu_torch")

NEG = -1e9
DEVICE_BEAM_MAX = 32                 # masr_tpu caps the device beam here
# rolling-hash multipliers (odd → invertible mod 2^32, independent mixes)
_MULT1 = 2654435761
_MULT2 = 40503
_MASK32 = 0xFFFFFFFF


def _mul32(h, m):
    """(h · m) mod 2^32 for int64 h in [0, 2^32) and a constant m < 2^32,
    without leaving int64's range: h = hi·2^16 + lo, so h·m ≡
    ((hi·m) mod 2^16)·2^16 + lo·m, each product below 2^48."""
    hi, lo = h >> 16, h & 0xFFFF
    return ((((hi * m) & 0xFFFF) << 16) + lo * m) & _MASK32


def extend_hash(h, tok, mult):
    """Hash of prefix + tok from the prefix's hash h (masr_tpu's
    h·mult + tok + 2 in uint32)."""
    return (_mul32(h, mult) + tok.to(torch.int64) + 2) & _MASK32


def _logsumexp2(a, b):
    m = torch.maximum(a, b)
    m_safe = torch.clamp(m, min=NEG)
    return m_safe + torch.log(torch.exp(a - m_safe) + torch.exp(b - m_safe))


def _top(x, k):
    """lax.top_k over the last axis: a stable descending sort, sliced (the
    lower index first among ties). → (values, indices)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def init_state(batch, beam_size, max_len, lm_vocab=0, device=None):
    """Fresh beam state: beam 0 is the empty prefix, the rest are dead.
    lm_vocab > 0 adds LM-fusion state: the accumulated shallow-fusion score
    and the last non-space token (row lm_vocab = empty context)."""
    W = beam_size

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    p_b = full((batch, W), NEG, torch.float32)
    p_b[:, 0] = 0.0
    state = {
        "tokens": full((batch, W, max_len), -1, torch.int32),
        "length": full((batch, W), 0, torch.int32),
        "last": full((batch, W), -1, torch.int32),
        "h1": full((batch, W), 0, torch.int64),
        "h2": full((batch, W), 0, torch.int64),
        "p_b": p_b,
        "p_nb": full((batch, W), NEG, torch.float32),
    }
    if lm_vocab:
        state["lm"] = full((batch, W), 0.0, torch.float32)
        state["lm_last"] = full((batch, W), lm_vocab, torch.int32)
    return state


def _segment_logsumexp(sorted_h1, sorted_h2, sorted_vals):
    """Merge log-values over runs of equal (h1, h2) in sorted (B, C)
    arrays. sorted_vals (B, C, n) holds n value columns → (merged values
    (B, C, n) on the FIRST element of each run, NEG elsewhere; run-start
    mask (B, C)). A segment reduce by run id: the run's max, the sum of
    exp(value - max), its log. masr_tpu runs log2(C) doubling passes of
    pairwise log-sum-exp instead; a run holds at most two candidates (a
    beam's stay and the one extension of its parent that spells it), and
    for two values both give m + log(exp(a - m) + exp(b - m))."""
    B, C, n = sorted_vals.shape
    same_prev = torch.cat(
        [torch.zeros((B, 1), dtype=torch.bool, device=sorted_vals.device),
         (sorted_h1[:, 1:] == sorted_h1[:, :-1])
         & (sorted_h2[:, 1:] == sorted_h2[:, :-1])], dim=1)
    start = ~same_prev
    # run id per element, from 0: monotone within a batch row
    run = (torch.cumsum(start, dim=1) - 1)[:, :, None].expand(B, C, n)
    top = torch.full_like(sorted_vals, NEG).scatter_reduce(
        1, run, sorted_vals, "amax", include_self=False)
    top = torch.gather(top, 1, run)
    total = torch.zeros_like(sorted_vals).scatter_add(
        1, run, torch.exp(sorted_vals - top))
    merged = top + torch.log(torch.gather(total, 1, run))
    return torch.where(start[:, :, None], merged,
                       torch.full_like(merged, NEG)), start


def beam_step(state, logp_t, valid_t, beam_size, cutoff_top_n, blank_id,
              lm_table=None, alpha=0.0, beta=0.0, space_id=-1):
    """One frame of batched prefix beam search.

    state: see init_state; logp_t (B, V) log-probs; valid_t (B,) bool.
    lm_table: optional (V_lm+1, V) dense log10 P(tok|prev) with Katz
    backoff baked in (row V_lm = empty context): shallow fusion
    alpha·log10P + beta per non-space token, the host engines'
    character-LM formula. → new state (a new dict; `state` is unchanged)."""
    B, W, Lmax = state["tokens"].shape
    K = min(cutoff_top_n, logp_t.shape[1])
    C = W + W * K
    dev = logp_t.device
    has_lm = lm_table is not None

    p_b, p_nb = state["p_b"], state["p_nb"]
    p_tot = _logsumexp2(p_b, p_nb)
    blank_lp = logp_t[:, blank_id][:, None]                      # (B, 1)
    last_tok = state["last"]
    last_lp = torch.gather(logp_t, 1, torch.clamp(last_tok, min=0).long())
    last_lp = torch.where(last_tok >= 0, last_lp,
                          torch.full_like(last_lp, NEG))         # (B, W)

    topv, topi = _top(logp_t, K)                                 # (B, K)
    topi = topi.to(torch.int32)

    # ---- candidates ------------------------------------------------- #
    # stay: same prefix by the blank path and the repeated-last path, each
    # credited only when blank / last survive the top-K token cutoff (as
    # the host engine's step loop does)
    blank_in = (topi == blank_id).any(dim=1, keepdim=True)       # (B, 1)
    last_in = (topi[:, None, :] == last_tok[:, :, None]).any(dim=2)
    neg = torch.full_like(p_tot, NEG)
    stay_pb = torch.where(blank_in, p_tot + blank_lp, neg)       # (B, W)
    stay_pnb = torch.where(last_in, p_nb + last_lp, neg)
    # extend: prefix + tok (B, W, K)
    tok = topi[:, None, :].expand(B, W, K)
    tok_lp = topv[:, None, :].expand(B, W, K)
    is_repeat = tok == last_tok[:, :, None]
    base = torch.where(is_repeat, p_b[:, :, None], p_tot[:, :, None])
    ext_pnb = base + tok_lp
    # blank extensions are not a new prefix: kill them (the stay candidate
    # already carries the blank path)
    ext_pnb = torch.where(tok == blank_id, torch.full_like(ext_pnb, NEG),
                          ext_pnb)
    ext_h1 = extend_hash(state["h1"][:, :, None], tok, _MULT1)
    ext_h2 = extend_hash(state["h2"][:, :, None], tok, _MULT2)

    # flatten: first W stays, then W*K extensions
    c_pb = torch.cat([stay_pb, torch.full((B, W * K), NEG, device=dev)],
                     dim=1)
    c_pnb = torch.cat([stay_pnb, ext_pnb.reshape(B, W * K)], dim=1)
    c_h1 = torch.cat([state["h1"], ext_h1.reshape(B, W * K)], dim=1)
    c_h2 = torch.cat([state["h2"], ext_h2.reshape(B, W * K)], dim=1)
    beams = torch.arange(W, dtype=torch.int64, device=dev)
    c_parent = torch.cat([beams, beams.repeat_interleave(K)])[None] \
        .expand(B, C)
    c_tok = torch.cat([torch.full((B, W), -1, dtype=torch.int32,
                                  device=dev), tok.reshape(B, W * K)], dim=1)
    if has_lm:
        lm_par, lm_last = state["lm"], state["lm_last"]
        cond = lm_table[lm_last[:, :, None].long(), tok.long()]  # (B, W, K)
        is_space = tok == space_id
        ext_lm = lm_par[:, :, None] + torch.where(
            is_space, torch.zeros_like(cond), alpha * cond + beta)
        ext_lm_last = torch.where(is_space, lm_last[:, :, None], tok)
        c_lm = torch.cat([lm_par, ext_lm.reshape(B, W * K)], dim=1)
        c_lm_last = torch.cat([lm_last, ext_lm_last.reshape(B, W * K)],
                              dim=1)
    else:
        c_lm = torch.zeros((B, C), dtype=torch.float32, device=dev)
        c_lm_last = torch.zeros((B, C), dtype=torch.int32, device=dev)
    # dead parents propose nothing
    parent_alive = p_tot > NEG / 2                                # (B, W)
    c_alive = torch.gather(parent_alive, 1, c_parent)
    c_pb = torch.where(c_alive, c_pb, torch.full_like(c_pb, NEG))
    c_pnb = torch.where(c_alive, c_pnb, torch.full_like(c_pnb, NEG))
    # give dead candidates distinct hashes so they cannot merge with live
    c_h1 = torch.where(c_alive, c_h1,
                       torch.arange(C, dtype=torch.int64, device=dev)[None]
                       + 0x80000000)

    # ---- merge equal prefixes: lexicographic (h1, h2), stable --------- #
    order = torch.sort(c_h2, dim=1, stable=True)[1]
    order = torch.gather(order, 1, torch.sort(
        torch.gather(c_h1, 1, order), dim=1, stable=True)[1])

    def srt(x):
        return torch.gather(x, 1, order)

    s_h1, s_h2, s_pb, s_pnb = srt(c_h1), srt(c_h2), srt(c_pb), srt(c_pnb)
    s_parent, s_tok, s_lm, s_lm_last = (srt(c_parent), srt(c_tok),
                                        srt(c_lm), srt(c_lm_last))
    merged, start = _segment_logsumexp(
        s_h1, s_h2, torch.stack([s_pb, s_pnb], dim=2))
    m_pb, m_pnb = merged[:, :, 0], merged[:, :, 1]
    # lm is a pure function of the prefix → equal within a segment
    total = torch.where(start, _logsumexp2(m_pb, m_pnb) + s_lm,
                        torch.full_like(m_pb, NEG))

    # ---- select top-W ------------------------------------------------ #
    sel_total, sel_idx = _top(total, W)                           # (B, W)

    def pick(x):
        return torch.gather(x, 1, sel_idx)

    n_pb, n_pnb = pick(m_pb), pick(m_pnb)
    n_parent, n_tok = pick(s_parent), pick(s_tok)
    n_h1, n_h2 = pick(s_h1), pick(s_h2)

    # rebuild the token arrays: gather the parents' prefixes, append tok
    parent_tokens = torch.gather(
        state["tokens"], 1, n_parent[:, :, None].expand(B, W, Lmax))
    parent_len = torch.gather(state["length"], 1, n_parent)
    parent_last = torch.gather(state["last"], 1, n_parent)
    is_ext = n_tok >= 0
    pos = torch.clamp(parent_len, max=Lmax - 1)
    onehot = (torch.arange(Lmax, device=dev)[None, None, :]
              == pos[:, :, None]) & is_ext[:, :, None]
    n_tokens = torch.where(onehot, n_tok[:, :, None], parent_tokens)
    n_length = parent_len + is_ext.to(torch.int32)
    n_last = torch.where(is_ext, n_tok, parent_last)

    dead = sel_total < NEG / 2
    n_pb = torch.where(dead, torch.full_like(n_pb, NEG), n_pb)
    n_pnb = torch.where(dead, torch.full_like(n_pnb, NEG), n_pnb)

    new_state = {"tokens": n_tokens, "length": n_length, "last": n_last,
                 "h1": n_h1, "h2": n_h2, "p_b": n_pb, "p_nb": n_pnb}
    if has_lm:
        new_state["lm"] = pick(s_lm)
        new_state["lm_last"] = pick(s_lm_last)
    # padded frames keep the old state
    return {k: torch.where(valid_t.reshape((B,) + (1,) * (v.dim() - 1)),
                           v, state[k])
            for k, v in new_state.items()}


def _log_probs(probs):
    return torch.log(torch.clamp(probs.to(torch.float32), min=1e-20))


def _scan(state, logp, valid, beam_size, cutoff_top_n, blank_id, lm_table,
          alpha, beta, space_id):
    """beam_step over the frames of logp (B, T, V) with valid (B, T)."""
    for t in range(logp.shape[1]):
        state = beam_step(state, logp[:, t], valid[:, t], beam_size,
                          cutoff_top_n, blank_id, lm_table=lm_table,
                          alpha=alpha, beta=beta, space_id=space_id)
    return state


def _totals(state):
    total = _logsumexp2(state["p_b"], state["p_nb"])
    if "lm" in state:
        total = total + state["lm"]
    return total


@torch.no_grad()
def ctc_beam_search(probs, lens, beam_size=10, cutoff_top_n=40, blank_id=0,
                    max_len=None, lm_table=None, alpha=2.2, beta=4.3,
                    space_id=-1):
    """Batched CTC prefix beam search on probs' device, optional shallow
    LM fusion (lm_table from `build_dense_bigram`, a character n-gram
    collapsed to dense bigram conditionals with backoff).

    probs: (B, T, V) softmax tensor; lens: (B,) valid frames.
    → (tokens (B, W, Lmax) padded -1, lengths (B, W), scores (B, W)), all
    on probs' device, beams sorted best-first; scores include the fusion
    term."""
    B, T, V = probs.shape
    dev = probs.device
    Lmax = max_len if max_len is not None else T
    if lm_table is not None:
        lm_table = torch.as_tensor(lm_table, dtype=torch.float32, device=dev)
    state = init_state(B, beam_size, Lmax,
                       lm_vocab=V if lm_table is not None else 0, device=dev)
    lens = torch.as_tensor(lens, device=dev)
    valid = torch.arange(T, device=dev)[None, :] < lens[:, None]
    state = _scan(state, _log_probs(probs), valid, beam_size, cutoff_top_n,
                  blank_id, lm_table, alpha, beta, space_id)
    scores = _totals(state)
    order = torch.argsort(scores, dim=1, descending=True, stable=True)
    return (torch.gather(state["tokens"], 1,
                         order[:, :, None].expand(B, beam_size, Lmax)),
            torch.gather(state["length"], 1, order),
            torch.gather(scores, 1, order))


def build_dense_bigram(language_model_path, vocab_list,
                       space_token="<space>"):
    """ARPA character LM → dense (V+1, V) float32 table of
    log10 P(tok | prev) with Katz backoff baked in; row V is the empty
    context. Each entry equals masr_tpu's
    ArpaLM.log10_cond([prev], tok): the bigram where the LM has it, else
    prev's backoff plus the unigram (or <unk>, or -99). masr_tpu loops over
    the V² pairs and caches the table beside the ARPA; here it is built
    with numpy in one pass over the LM's bigrams, so nothing is cached."""
    from masr_tpu_torch.decoders.scorer import LOG10_NEG_INF, ArpaLM
    lm = ArpaLM(language_model_path)
    V = len(vocab_list)
    chars = [" " if t == space_token else t for t in vocab_list]
    unk = lm.ngrams.get(("<unk>",))
    floor = unk[0] if unk is not None else LOG10_NEG_INF
    uni = np.asarray([lm.ngrams[(c,)][0] if (c,) in lm.ngrams else floor
                      for c in chars], np.float64)
    table = np.empty((V + 1, V), np.float64)
    table[V] = uni
    if lm.order < 2:
        table[:V] = uni[None, :]
        return table.astype(np.float32)
    backoff = np.asarray([lm.ngrams[(c,)][1] if (c,) in lm.ngrams else 0.0
                          for c in chars], np.float64)
    table[:V] = backoff[:, None] + uni[None, :]
    ids = {}
    for i, c in enumerate(chars):
        ids.setdefault(c, []).append(i)
    for words, (logp, _) in lm.ngrams.items():
        if len(words) == 2 and words[0] in ids and words[1] in ids:
            for p in ids[words[0]]:
                table[p, ids[words[1]]] = logp
    return table.astype(np.float32)


def make_stream_decode_fn(beam_size=10, cutoff_top_n=40, blank_id=0,
                          lm_table=None, alpha=2.2, beta=4.3, space_id=-1,
                          max_len=4096, device=None):
    """→ (init_fn, decode_fn): the streaming beam as functions of the state,
    so a caller runs it right after its encoder chunk step on the same
    device (masr_tpu fuses it into the chunk program), reading back only
    the winning hypothesis per slot.

    init_fn(batch) → fresh decode state (tensors on `device`).
    decode_fn(state, probs_chunk (B, Tc, V), frame_valid (B, Tc) bool) →
    (state, (tokens (B, max_len) int32 −1-padded, lengths (B,), scores
    (B,))), tensors on the state's device: the best beam per slot; padded
    frames leave the state untouched, so one function serves every chunk,
    the final partial one included."""
    lm = None if lm_table is None else torch.as_tensor(
        lm_table, dtype=torch.float32, device=device)

    def init_fn(batch):
        return init_state(batch, beam_size, max_len,
                          lm_vocab=lm.shape[1] if lm is not None else 0,
                          device=device)

    @torch.no_grad()
    def decode_fn(state, probs_chunk, frame_valid):
        frame_valid = torch.as_tensor(frame_valid, dtype=torch.bool,
                                      device=probs_chunk.device)
        state = _scan(state, _log_probs(probs_chunk), frame_valid,
                      beam_size, cutoff_top_n, blank_id, lm, alpha, beta,
                      space_id)
        total = _totals(state)
        w = torch.argmax(total, dim=1)                           # (B,)
        B, _, L = state["tokens"].shape
        tokens = torch.gather(state["tokens"], 1,
                              w[:, None, None].expand(B, 1, L))[:, 0]
        lengths = torch.gather(state["length"], 1, w[:, None])[:, 0]
        scores = torch.gather(total, 1, w[:, None])[:, 0]
        return state, (tokens, lengths, scores)

    return init_fn, decode_fn


class DeviceBeamStream(object):
    """Stateful CHUNKED beam search for batched streaming serving: N slots
    advance together; inactive slots pass frame_valid False and keep their
    state (the same masking the batched encoder step uses). The state lives
    on `device`, the card unless the caller asks for the CPU."""

    def __init__(self, batch, beam_size=10, cutoff_top_n=40, blank_id=0,
                 max_len=512, lm_table=None, alpha=2.2, beta=4.3,
                 space_id=-1, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"device {self.device} requested but "
                                   "CUDA is not available")
            if self.device.index is None:
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
        self.batch = batch
        self.beam_size = beam_size
        self.max_len = max_len
        self._init, self._decode = make_stream_decode_fn(
            beam_size=beam_size, cutoff_top_n=cutoff_top_n,
            blank_id=blank_id, lm_table=lm_table, alpha=alpha, beta=beta,
            space_id=space_id, max_len=max_len, device=self.device)
        self._fresh = self._init(batch)
        self.state = {k: v.clone() for k, v in self._fresh.items()}

    def feed(self, probs_chunk, frame_valid=None):
        """probs_chunk (B, Tc, V) softmax, an array or a tensor on the
        stream's device (a tensor on another device raises: the beams do
        not follow it); frame_valid (B, Tc) bool marks real frames per slot
        (None = all valid): inactive slots and padded frames leave their
        beam state untouched."""
        if torch.is_tensor(probs_chunk) and probs_chunk.device != self.device:
            raise ValueError(f"probs on {probs_chunk.device}, the beams on "
                             f"{self.device}")
        probs_chunk = torch.as_tensor(probs_chunk, device=self.device)
        if frame_valid is None:
            frame_valid = torch.ones(probs_chunk.shape[:2], dtype=torch.bool)
        self.state, _ = self._decode(self.state, probs_chunk, frame_valid)

    def reset_slots(self, slots):
        for k, v in self.state.items():
            v[list(slots)] = self._fresh[k][list(slots)]

    def best(self, slot=None):
        """→ (token_ids list, score) for one slot, or a list for all."""
        scores = _totals(self.state).cpu().numpy()
        tokens = self.state["tokens"].cpu().numpy()
        lengths = self.state["length"].cpu().numpy()
        best_w = scores.argmax(axis=1)
        out = []
        for b in range(self.batch):
            w = best_w[b]
            out.append(([int(t) for t in tokens[b, w, : lengths[b, w]]],
                        float(scores[b, w])))
        return out[slot] if slot is not None else out


def ids_to_text(ids, vocab_list, space_token="<space>"):
    return "".join(" " if vocab_list[i] == space_token else vocab_list[i]
                   for i in ids)


def decode_batch_device(probs, lens, vocab_list, beam_size=10,
                        cutoff_top_n=40, blank_id=0, space_token="<space>",
                        lm_table=None, alpha=2.2, beta=4.3):
    """→ [(score, text)], the best hypothesis per utterance (the result
    contract of BeamSearchDecoder's batch API). probs: (B, T, V) tensor
    (the search runs on its device) or array (the CPU); lm_table (from
    build_dense_bigram) turns on shallow fusion."""
    space_id = space_id_of(vocab_list, space_token)
    probs = torch.as_tensor(probs)
    tokens, lengths, scores = ctc_beam_search(
        probs, lens, beam_size=beam_size, cutoff_top_n=cutoff_top_n,
        blank_id=blank_id, lm_table=lm_table, alpha=alpha, beta=beta,
        space_id=space_id)
    tokens = tokens[:, 0].cpu().numpy()
    lengths = lengths[:, 0].cpu().numpy()
    scores = scores[:, 0].cpu().numpy()
    return [(float(scores[b]),
             ids_to_text(tokens[b, : lengths[b]], vocab_list, space_token))
            for b in range(tokens.shape[0])]


def device_beam_conf(conf, vocab_list, device):
    """A decoder config (the predictor's decoder_configs, the trainer's
    ctc_beam_search_decoder_conf or the engine's decoder_conf) → the
    device beam's keywords: beam_size (at most DEVICE_BEAM_MAX),
    cutoff_top_n, alpha, beta, and lm_table on `device`: the config's own
    lm_table (build_dense_bigram's), else the dense bigram of an ARPA
    language_model_path (a KenLM binary is refused with a warning, as
    masr_tpu does), else None."""
    lm_table = conf.get("lm_table")
    lm_path = conf.get("language_model_path")
    if lm_table is None and lm_path and os.path.exists(lm_path):
        from masr_tpu_torch.decoders.scorer import is_kenlm_binary
        if is_kenlm_binary(lm_path):
            logger.warning("device beam fuses ARPA LMs only; decoding "
                           "without LM")
        else:
            lm_table = build_dense_bigram(lm_path, vocab_list)
    if lm_table is not None:
        lm_table = torch.as_tensor(lm_table, dtype=torch.float32,
                                   device=device)
    return dict(beam_size=min(int(conf.get("beam_size", 10)),
                              DEVICE_BEAM_MAX),
                cutoff_top_n=int(conf.get("cutoff_top_n", 40)),
                lm_table=lm_table, alpha=float(conf.get("alpha", 2.2)),
                beta=float(conf.get("beta", 4.3)))


def space_id_of(vocab_list, space_token="<space>"):
    return vocab_list.index(space_token) if space_token in vocab_list \
        else -1
