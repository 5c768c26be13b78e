"""CTC prefix beam search with optional n-gram LM (port of
masr_tpu/decoders/beam_search.py: offline, batch, and stateful streaming
decode).

Two engines, same semantics:
- the native C++ extension (masr_tpu_torch/decoders/native/, built with
  g++ at first use into build/decoders/ and loaded with ctypes) — the fast
  path;
- a pure-Python fallback used for hotwords, for KenLM binaries, and when
  the extension does not build.
`BeamSearchDecoder.engine` says which one a decoder runs: "native" or
"python".

Like the reference, decoding works on softmax probs; LM fusion adds
alpha*log10 P_lm + beta per completed word (char for char LMs).
"""
import logging
import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from masr_tpu_torch.data.text_featurizer import SPACE_TOKEN
from masr_tpu_torch.decoders.scorer import Scorer

logger = logging.getLogger("masr_tpu_torch")

NEG_INF = -float("inf")


def _log_sum_exp(*xs):
    m = max(xs)
    if m == NEG_INF:
        return NEG_INF
    return m + math.log(sum(math.exp(x - m) for x in xs))


class _PyPrefixBeamSearch(object):
    """Pure-Python stateful prefix beam search over one stream."""

    def __init__(self, vocab_list, beam_size=300, cutoff_prob=0.99,
                 cutoff_top_n=40, blank_id=0, scorer=None,
                 hotword_scorer=None):
        self.vocab_list = vocab_list
        self.beam_size = beam_size
        self.cutoff_prob = cutoff_prob
        self.cutoff_top_n = cutoff_top_n
        self.blank_id = blank_id
        self.scorer = scorer
        self.hotword_scorer = hotword_scorer
        self.reset()

    def reset(self):
        # prefix (tuple of token ids) -> [p_blank, p_non_blank, lm_score]
        self.beams = {(): [0.0, NEG_INF, 0.0]}

    def _char(self, tid):
        tok = self.vocab_list[tid]
        return " " if tok == SPACE_TOKEN else tok

    def _lm_delta(self, prefix, tid):
        """LM score increment for appending token tid to prefix."""
        if self.scorer is None:
            return 0.0
        ch = self._char(tid)
        if self.scorer.is_character_based:
            if ch == " ":
                return 0.0
            context = [self._char(t) for t in prefix if self._char(t) != " "]
            return self.scorer.score_word(context, ch)
        # word-based: score the completed word when a space arrives
        if ch != " ":
            return 0.0
        text = "".join(self._char(t) for t in prefix)
        words = [w for w in text.split(" ") if w]
        if not words:
            return 0.0
        return self.scorer.score_word(words[:-1], words[-1])

    def _hot_delta(self, prefix, tid):
        """Contextual-biasing increment for appending token tid."""
        if self.hotword_scorer is None:
            return 0.0
        ctx = [self._char(t) for t in prefix]
        return self.hotword_scorer.delta(ctx, self._char(tid))

    def step(self, probs):
        """Advance over (T, V) softmax probs."""
        eps = 1e-20
        for frame in probs:
            log_frame = np.log(np.maximum(frame, eps))
            # pruning: top tokens within cutoff_prob mass, max cutoff_top_n
            order = np.argsort(frame)[::-1]
            csum = np.cumsum(frame[order])
            n = int(np.searchsorted(csum, self.cutoff_prob) + 1)
            cand = order[: min(max(n, 1), self.cutoff_top_n)]
            new_beams = {}

            def get(prefix):
                return new_beams.setdefault(prefix, [NEG_INF, NEG_INF, 0.0])

            for prefix, (p_b, p_nb, lm) in self.beams.items():
                p_tot = _log_sum_exp(p_b, p_nb)
                for tid in cand:
                    tid = int(tid)
                    lp = float(log_frame[tid])
                    if tid == self.blank_id:
                        e = get(prefix)
                        e[0] = _log_sum_exp(e[0], p_tot + lp)
                        e[2] = lm
                        continue
                    last = prefix[-1] if prefix else None
                    if tid == last:
                        # repeat: extends p_nb of same prefix...
                        e = get(prefix)
                        e[1] = _log_sum_exp(e[1], p_nb + lp)
                        e[2] = lm
                        # ...or new token after a blank
                        np_prefix = prefix + (tid,)
                        e2 = get(np_prefix)
                        d = self._lm_delta(prefix, tid) \
                            + self._hot_delta(prefix, tid)
                        e2[1] = _log_sum_exp(e2[1], p_b + lp)
                        e2[2] = lm + d
                    else:
                        np_prefix = prefix + (tid,)
                        e2 = get(np_prefix)
                        d = self._lm_delta(prefix, tid) \
                            + self._hot_delta(prefix, tid)
                        e2[1] = _log_sum_exp(e2[1], p_tot + lp)
                        e2[2] = lm + d
            # prune to beam_size by combined score
            scored = sorted(
                new_beams.items(),
                key=lambda kv: _log_sum_exp(kv[1][0], kv[1][1]) + kv[1][2],
                reverse=True)
            self.beams = dict(scored[: self.beam_size])

    def result(self):
        """→ (combined_log_score, text) for the best prefix."""
        best, vals = max(
            self.beams.items(),
            key=lambda kv: _log_sum_exp(kv[1][0], kv[1][1]) + kv[1][2])
        text = "".join(self._char(t) for t in best)
        score = _log_sum_exp(vals[0], vals[1]) + vals[2]
        return score, text

    def result_nbest(self, n):
        """→ [(score, token_ids)], best first."""
        scored = sorted(
            ((_log_sum_exp(v[0], v[1]) + v[2], list(p))
             for p, v in self.beams.items()), key=lambda x: -x[0])
        return scored[:n]


def _native_module():
    try:
        from masr_tpu_torch.decoders import native
        native.get_lib()
        return native
    except Exception as e:
        logger.warning(f"native CTC decoder unavailable ({e}); "
                       f"using the Python engine")
        return None


class BeamSearchDecoder(object):
    """Public decoder facade (masr_tpu/decoders/beam_search.py:141)."""

    def __init__(self, vocab_list, alpha=2.2, beta=4.3, beam_size=300,
                 num_processes=10, cutoff_prob=0.99, cutoff_top_n=40,
                 language_model_path=None, blank_id=0, use_native=True,
                 hotwords=None, hotword_score=3.0):
        """hotwords: phrases to contextually bias toward (list of strings
        for char decoding, or lists of tokens); hotword_score is the
        per-token boost. Biasing runs in the Python engine."""
        self.vocab_list = vocab_list
        self.alpha, self.beta = alpha, beta
        self.beam_size = beam_size
        self.num_processes = num_processes
        self.cutoff_prob = cutoff_prob
        self.cutoff_top_n = cutoff_top_n
        self.blank_id = blank_id
        self.hotword_scorer = None
        if hotwords:
            from masr_tpu_torch.decoders.scorer import HotwordScorer
            self.hotword_scorer = HotwordScorer(hotwords,
                                                boost=hotword_score)
            if use_native:
                logger.info("hotword biasing uses the Python beam engine")
                use_native = False
        self._native = _native_module() if use_native else None
        self.scorer = None
        self._native_scorer = None
        if language_model_path:
            import os
            if os.path.exists(language_model_path):
                from masr_tpu_torch.decoders.scorer import is_kenlm_binary
                if is_kenlm_binary(language_model_path):
                    # KenLM BINARY (.klm): PROBING files score through
                    # the in-repo reader (decoders/klm_probing.py) or the
                    # kenlm package when installed — the reference users'
                    # migration path (probing binaries cannot be
                    # converted to ARPA). The Python engine carries the
                    # scorer; the C++ engine reads ARPA only.
                    try:
                        from masr_tpu_torch.decoders.scorer import KenlmScorer
                        self.scorer = KenlmScorer(alpha, beta,
                                                  language_model_path,
                                                  vocab_list)
                        self._native = None
                        logger.info("KenLM binary LM loaded (Python beam "
                                    "engine)")
                    except Exception as e:
                        logger.warning(
                            f"cannot score KenLM binary "
                            f"{language_model_path} ({e}); TRIE-format "
                            f"files need `pip install kenlm` or the ARPA "
                            f"variant (tools/convert_lm.py --inspect). "
                            f"Decoding without LM.")
                elif self._native is not None:
                    self._native_scorer = self._native.NativeScorer(
                        alpha, beta, language_model_path)
                else:
                    self.scorer = Scorer(alpha, beta, language_model_path,
                                         vocab_list)
            else:
                logger.warning(f"language model not found: "
                               f"{language_model_path}; decoding without LM")
        self._stream = None

    @property
    def engine(self):
        """The engine every decode of this decoder runs: "native" (the C++
        library) or "python"."""
        return "native" if self._native is not None else "python"

    def _new_engine(self):
        if self._native is not None:
            return self._native.NativeDecoder(
                self.vocab_list, self.blank_id, self.beam_size,
                self.cutoff_prob, self.cutoff_top_n, self._native_scorer)
        return _PyPrefixBeamSearch(self.vocab_list, self.beam_size,
                                   self.cutoff_prob, self.cutoff_top_n,
                                   self.blank_id, self.scorer,
                                   hotword_scorer=self.hotword_scorer)

    # -------------------------- offline ------------------------------- #
    def decode_beam_search_offline(self, probs_seq):
        """(T, V) softmax probs → (score, text)."""
        engine = self._new_engine()
        engine.step(np.asarray(probs_seq, np.float32))
        return engine.result()

    def decode_nbest(self, probs_seq, n):
        """(T, V) softmax probs → [(score, token_ids)] top-n prefixes
        (used by attention rescoring)."""
        engine = self._new_engine()
        engine.step(np.asarray(probs_seq, np.float32))
        return engine.result_nbest(n)

    def decode_batch_beam_search_offline(self, probs_split):
        """List of per-utterance probs → [(score, text)]. The native engine
        releases the GIL inside ctypes calls, so a thread pool gives real
        parallelism (mirrors the reference's num_processes batch decode)."""
        if len(probs_split) == 1:
            return [self.decode_beam_search_offline(probs_split[0])]
        with ThreadPoolExecutor(min(self.num_processes,
                                    max(len(probs_split), 1))) as pool:
            return list(pool.map(self.decode_beam_search_offline, probs_split))

    # -------------------------- streaming ------------------------------ #
    def decode_chunk(self, probs_chunk):
        """Stateful chunk decode → (score, text) of current best prefix."""
        if self._stream is None:
            self._stream = self._new_engine()
        self._stream.step(np.asarray(probs_chunk, np.float32))
        return self._stream.result()

    def nbest_state(self, n):
        """Current stream's top-n prefixes → [(score, token_ids)]."""
        if self._stream is None:
            return []
        return self._stream.result_nbest(n)

    def reset_state(self):
        if self._stream is not None:
            self._stream.reset()
