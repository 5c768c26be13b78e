"""(Copy of masr_tpu/decoders/scorer.py.)

ARPA backoff n-gram LM scorer (replaces the KenLM dependency of the
reference's external `paddlespeech_ctcdecoders` Scorer,
masr/decoders/swig_wrapper.py:9-34).

Reads standard ARPA text files (optionally gzipped) into a hash table and
scores with Katz backoff. Scoring unit is a "word": whitespace-delimited
for word LMs, single characters for character LMs (is_character_based).
The combined shallow-fusion score matches the reference convention:
  alpha * log10 P_lm(word|ctx) + beta   (per completed word)
"""
import gzip

LOG10_NEG_INF = -99.0


class ArpaLM(object):
    def __init__(self, path):
        self.ngrams = {}  # tuple(words) -> (logp, backoff)
        self.order = 0
        self._load(path)

    def _load(self, path):
        opener = gzip.open if str(path).endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8", errors="replace") as f:
            section = None
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if line.startswith("\\") and "grams:" in line:
                    section = int(line[1:line.index("-")])
                    self.order = max(self.order, section)
                    continue
                if line.startswith("\\") or line.startswith("ngram"):
                    if line == "\\end\\":
                        break
                    continue
                if section is None:
                    continue
                parts = line.split("\t")
                if len(parts) < 2:
                    continue
                logp = float(parts[0])
                words = tuple(parts[1].split())
                backoff = float(parts[2]) if len(parts) > 2 else 0.0
                self.ngrams[words] = (logp, backoff)

    def log10_cond(self, context, word):
        """log10 P(word | context) with Katz backoff."""
        ctx = tuple(context)[-(self.order - 1):] if self.order > 1 else ()
        while True:
            entry = self.ngrams.get(ctx + (word,))
            if entry is not None:
                return entry[0]
            if not ctx:
                unk = self.ngrams.get(("<unk>",))
                return unk[0] if unk is not None else LOG10_NEG_INF
            bo = self.ngrams.get(ctx)
            backoff = bo[1] if bo is not None else 0.0
            ctx = ctx[1:]
            entry = self.ngrams.get(ctx + (word,))
            if entry is not None:
                return backoff + entry[0]
            # continue backing off, accumulating is handled by recursion:
            return backoff + self.log10_cond(ctx, word)


class Scorer(object):
    """Shallow-fusion scorer (parity: swig_wrapper Scorer(alpha, beta,
    lm_path, vocab)). Character-based iff the LM's unigrams are
    single CJK characters."""

    def __init__(self, alpha, beta, language_model_path, vocabulary=None):
        self.alpha = alpha
        self.beta = beta
        self.lm = ArpaLM(language_model_path) if language_model_path else None
        self.is_character_based = self._detect_character_based() \
            if self.lm else True

    def _detect_character_based(self):
        n, single = 0, 0
        for words in self.lm.ngrams:
            if len(words) == 1 and words[0] not in ("<s>", "</s>", "<unk>"):
                n += 1
                if len(words[0]) == 1:
                    single += 1
                if n >= 200:
                    break
        return n > 0 and single / n > 0.9

    def words_of(self, text):
        if self.is_character_based:
            return [c for c in text if c != " "]
        return [w for w in text.split(" ") if w]

    def score_word(self, context_words, word):
        """alpha * log10 P(word|ctx) + beta for one completed word."""
        if self.lm is None:
            return self.beta
        return self.alpha * self.lm.log10_cond(context_words, word) + self.beta


class HotwordScorer(object):
    """Contextual biasing (beyond the reference — the WeNet/Icefall
    hotword mechanism): prefixes of registered phrases earn `boost` per
    matched token while the hypothesis stays on a phrase prefix, with the
    bonus rolled back automatically when the match dies (the per-token
    delta is boost·Δdepth where depth = longest hypothesis suffix that is
    a phrase prefix). A completed phrase keeps a permanent extra bonus.

    Works on the decoder's scoring units: characters for zh (phrase
    strings are split per char), words for word-level decoding (pass
    phrases as lists of tokens)."""

    def __init__(self, hotwords, boost=3.0, match_bonus=None):
        self.boost = float(boost)
        self.match_bonus = float(boost if match_bonus is None
                                 else match_bonus)
        self.phrases = set()
        self.prefixes = set()
        self.max_len = 0
        for phrase in hotwords or []:
            toks = tuple(phrase) if isinstance(phrase, str) else tuple(phrase)
            if not toks:
                continue
            self.phrases.add(toks)
            self.max_len = max(self.max_len, len(toks))
            for i in range(1, len(toks) + 1):
                self.prefixes.add(toks[:i])

    def _depth(self, toks):
        """Longest suffix of toks that is a proper prefix of a phrase
        (full matches are banked separately and do not hold depth)."""
        n = min(len(toks), self.max_len)
        for k in range(n, 0, -1):
            suf = tuple(toks[-k:])
            if suf in self.prefixes and suf not in self.phrases:
                return k
        return 0

    def delta(self, context_tokens, new_token):
        """Score increment for appending new_token to context_tokens."""
        if not self.prefixes:
            return 0.0
        old = list(context_tokens)
        new = old + [new_token]
        d = self.boost * (self._depth(new) - self._depth(old))
        # completed phrases ending at the new token bank their full bonus:
        # the Δdepth term above just rolled back the (k−1)·boost partial
        # credit, so re-grant the whole phrase worth plus the match bonus
        n = min(len(new), self.max_len)
        for k in range(1, n + 1):
            if tuple(new[-k:]) in self.phrases:
                d += self.boost * k + self.match_bonus
        return d


KENLM_MAGIC = b"mmap lm http://kheafield.com/code format version"


def is_kenlm_binary(path):
    """True iff `path` is a KenLM binary (.klm) — identified by the
    format's magic sanity header, not the extension."""
    try:
        with open(path, "rb") as f:
            return f.read(len(KENLM_MAGIC)) == KENLM_MAGIC
    except OSError:
        return False


class KenlmScorer(object):
    """Shallow-fusion scorer over a KenLM BINARY model (.klm) — the
    migration path for reference users' binary LMs (their
    `paddlespeech_ctcdecoders` bundled KenLM, swig_wrapper.py:9-34).

    Probing-format binaries store only n-gram hashes, so .klm → ARPA
    conversion is information-theoretically impossible; scoring the
    binary directly is the only faithful way to keep using them. Backend
    order: the `kenlm` pip package when importable (covers every binary
    format), otherwise the in-repo probing-format reader
    (decoders/klm_probing.py — PROBING files, i.e. KenLM's default
    build_binary output and what the reference ships). Same interface as
    `Scorer` (is_character_based, words_of, score_word), so it drops
    into the Python beam engine unchanged.
    """

    def __init__(self, alpha, beta, language_model_path, vocabulary=None,
                 character_based=None):
        try:
            import kenlm  # preferred: pip install kenlm
            self._kenlm = kenlm
            self.model = kenlm.Model(language_model_path)
        except ImportError:
            from masr_tpu_torch.decoders import klm_probing
            self._kenlm = klm_probing
            # dispatches PROBING and TRIE binaries by header model_type
            self.model = klm_probing.load_klm(language_model_path)
        self.alpha = alpha
        self.beta = beta
        self.is_character_based = self._detect_character_based() \
            if character_based is None else bool(character_based)

    def _detect_character_based(self):
        """Char LMs (the reference's zh models) carry single CJK chars as
        unigrams; word LMs don't."""
        probes = ["的", "是", "我", "好", "天"]
        try:
            return any(p in self.model for p in probes)
        except Exception:
            return True

    def words_of(self, text):
        if self.is_character_based:
            return [c for c in text if c != " "]
        return [w for w in text.split(" ") if w]

    def log10_cond(self, context, word):
        """log10 P(word | context) by threading KenLM state through the
        context (BaseScore returns the conditional log10 prob)."""
        order = getattr(self.model, "order", 5)
        st = self._kenlm.State()
        self.model.NullContextWrite(st)  # no <s>: mid-utterance scoring
        for w in list(context)[-(order - 1):]:
            nxt = self._kenlm.State()
            self.model.BaseScore(st, w, nxt)
            st = nxt
        out = self._kenlm.State()
        return self.model.BaseScore(st, word, out)

    def score_word(self, context_words, word):
        return self.alpha * self.log10_cond(context_words, word) + self.beta
