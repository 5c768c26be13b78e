"""(Copy of masr_tpu/decoders/klm_probing.py.)

KenLM PROBING-format binary language models, natively (no `kenlm`
package): an mmap reader exposing the kenlm query API subset the
decoders use (Model/State/NullContextWrite/BaseScore), and a writer that
builds a probing `.klm` from an ARPA file.

Why: the reference decodes with a 2.8 GB probing-format KenLM binary
(reference masr/decoders/beam_search_decoder.py:19-29). Probing binaries
store only 64-bit n-gram hashes, so they cannot be converted back to
ARPA; scoring them directly is the only migration path, and the `kenlm`
pip package is not installable in a zero-egress image. This module
implements the on-disk format from the KenLM sources' documented layout
(kenlm lm/binary_format.{hh,cc}, lm/vocab.{hh,cc},
lm/search_hashed.hh, util/probing_hash_table.hh — LGPL headers; layout
re-derived, no code copied):

  [Sanity header: magic string + float/int sanity values]
  [FixedWidthParameters: order, probing_multiplier, model_type,
   has_vocabulary, search_version]
  [uint64 counts[order]]                    (padded to 8 bytes)
  [ProbingVocabulary: 16-byte header + open-addressing hash table of
   (uint64 MurmurHash64A(word), uint32 id) 12-byte entries]
  [Unigram array: (counts[0]+1) × (float prob, float backoff)]
  [per middle order 2..n-1: probing table of
   (uint64 key, float prob, float backoff) 16-byte entries]
  [longest order: probing table of (uint64 key, float prob)]
  [optional trailing NUL-separated word strings]

N-gram keys chain newest-word-first: key = id(w_n); then for each
context word going backwards key = key*8978948897894561157 + id(w).
Tables are linear-probing with ideal slot `key % buckets`,
buckets = max(entries+1, multiplier*entries), empty slot key == 0.

Round-trip (write_probing → ProbingModel) is exhaustively tested against
the in-repo ARPA scorer (tests/test_klm_binary.py). Byte-level
compatibility with binaries produced by real KenLM follows this layout
by construction but cannot be verified in this image (no kenlm build and
no existing .klm reachable) — see docs/design_deviations.md.
"""
import math
import struct

import numpy as np

MAGIC = b"mmap lm http://kheafield.com/code format version 5\n\0\0"
_SANITY_SIZE = 88          # magic padded to 56 + 3f + 2I + pad + Q
_FIXED_SIZE = 20           # uchar+pad, float, int, bool+pad, uint
_COMBINE = 8978948897894561157  # CombineWordHash multiplier
_MASK64 = (1 << 64) - 1

MODEL_PROBING = 0
MODEL_REST_PROBING = 1
MODEL_TRIE = 2

# ------------------------------------------------------------------ #
# shared layout math
# ------------------------------------------------------------------ #


def _align8(x):
    return (x + 7) & ~7


def _buckets(entries, multiplier):
    return max(entries + 1, int(multiplier * float(entries)))


def murmur64a(data, seed=0):
    """MurmurHash64A (Austin Appleby, public domain) — KenLM's vocab
    word hash (util/murmur_hash.cc)."""
    m = 0xC6A4A7935BD1E995
    r = 47
    h = (seed ^ ((len(data) * m) & _MASK64)) & _MASK64
    n8 = len(data) & ~7
    for i in range(0, n8, 8):
        k = int.from_bytes(data[i:i + 8], "little")
        k = (k * m) & _MASK64
        k ^= k >> r
        k = (k * m) & _MASK64
        h = (h ^ k) & _MASK64
        h = (h * m) & _MASK64
    tail = data[n8:]
    if tail:
        h ^= int.from_bytes(tail, "little")
        h = (h * m) & _MASK64
    h ^= h >> r
    h = (h * m) & _MASK64
    h ^= h >> r
    return h


def _layout(order, counts, multiplier):
    """→ dict of section offsets (relative to file start)."""
    off = {}
    header = _align8(_SANITY_SIZE + _FIXED_SIZE + 8 * order)
    off["vocab_header"] = header
    off["vocab_table"] = header + 16
    vocab_buckets = _buckets(counts[0], multiplier)
    off["vocab_buckets"] = vocab_buckets
    pos = off["vocab_table"] + 12 * vocab_buckets
    pos = _align8(pos)
    off["unigram"] = pos
    pos += 8 * (counts[0] + 1)
    off["middle"] = []
    for o in range(2, order):
        nb = _buckets(counts[o - 1], multiplier)
        off["middle"].append((pos, nb))
        pos += 16 * nb
    if order > 1:
        nb = _buckets(counts[order - 1], multiplier)
        off["longest"] = (pos, nb)
        pos += 12 * nb
    else:
        off["longest"] = (pos, 0)
    off["end"] = pos
    return off


def _chain_key(word_id, context_ids):
    """n-gram key: newest word id, extended with context ids going
    backwards in time (detail::CombineWordHash)."""
    key = word_id & _MASK64
    for cid in context_ids:
        key = (key * _COMBINE + cid) & _MASK64
    return key


# ------------------------------------------------------------------ #
# writer
# ------------------------------------------------------------------ #


def _read_arpa(path):
    """ARPA text → (order, [dict per order: tuple(words)->(logp, bo)])."""
    import gzip
    opener = gzip.open if str(path).endswith(".gz") else open
    grams = {}
    with opener(path, "rt", encoding="utf-8", errors="replace") as f:
        section = None
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("\\") and "grams:" in line:
                section = int(line[1:line.index("-")])
                grams.setdefault(section, {})
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
            bo = float(parts[2]) if len(parts) > 2 else 0.0
            if len(words) == section:
                grams[section][words] = (logp, bo)
    order = max(grams)
    return order, [grams.get(o + 1, {}) for o in range(order)]


def _table_insert(keys_arr, ideal, key, payload_setter):
    """Linear-probing insert into a numpy-backed open table."""
    n = len(keys_arr)
    i = ideal
    while keys_arr[i] != 0:
        i = (i + 1) % n
    keys_arr[i] = key
    payload_setter(i)


def write_probing(arpa_path, out_path, multiplier=1.5,
                  include_vocab_strings=True):
    """Build a PROBING-format .klm from an ARPA file. Returns the vocab
    (word → id) used."""
    order, grams = _read_arpa(arpa_path)
    unigrams = grams[0]
    # vocab: <unk> is id 0 (never in the table); others get ids in ARPA
    # unigram order (ProbingVocabulary::Insert semantics)
    vocab = {}
    next_id = 1
    for (w,) in unigrams:
        if w in ("<unk>", "<UNK>"):
            vocab[w] = 0
        else:
            vocab[w] = next_id
            next_id += 1
    counts = [len(g) for g in grams]
    lay = _layout(order, counts, multiplier)

    blob = bytearray(lay["end"])
    # sanity header
    s = bytearray(_SANITY_SIZE)
    s[:len(MAGIC)] = MAGIC
    struct.pack_into("<fffII", s, 56, 0.0, 1.0, -0.5, 1, 0xFFFFFFFF)
    struct.pack_into("<Q", s, 80, 1)
    blob[:_SANITY_SIZE] = s
    struct.pack_into("<B3xfi?3xI", blob, _SANITY_SIZE,
                     order, multiplier, MODEL_PROBING,
                     include_vocab_strings, 0)
    struct.pack_into("<%dQ" % order, blob, _SANITY_SIZE + _FIXED_SIZE,
                     *counts)
    # vocab header: version, bound (= number of ids incl. <unk>)
    struct.pack_into("<QQ", blob, lay["vocab_header"], 0, next_id)
    # vocab probing table
    vb = lay["vocab_buckets"]
    vkeys = np.zeros(vb, np.uint64)
    vvals = np.zeros(vb, np.uint32)
    for w, wid in vocab.items():
        if wid == 0:
            continue
        h = murmur64a(w.encode("utf-8"))
        if h == 0:
            h = 1   # 0 marks empty slots

        def put(i, wid=wid):
            vvals[i] = wid
        _table_insert(vkeys, int(h % vb), h, put)
    for i in range(vb):
        struct.pack_into("<QI", blob, lay["vocab_table"] + 12 * i,
                         int(vkeys[i]), int(vvals[i]))
    # unigram array (id-indexed)
    uni = np.zeros((counts[0] + 1, 2), np.float32)
    uni[0, 0] = -100.0   # <unk> default if absent
    for (w,), (lp, bo) in unigrams.items():
        uni[vocab[w]] = (lp, bo)
    blob[lay["unigram"]:lay["unigram"] + uni.nbytes] = uni.tobytes()
    # middle + longest tables
    for oi, (pos, nb) in enumerate(lay["middle"]):
        okeys = np.zeros(nb, np.uint64)
        ovals = np.zeros((nb, 2), np.float32)
        for words, (lp, bo) in grams[oi + 1].items():
            ids = [vocab.get(w, 0) for w in words]
            key = _chain_key(ids[-1], reversed(ids[:-1]))
            if key == 0:
                key = 1

            def put(i, lp=lp, bo=bo):
                ovals[i] = (lp, bo)
            _table_insert(okeys, int(key % nb), key, put)
        for i in range(nb):
            struct.pack_into("<Qff", blob, pos + 16 * i, int(okeys[i]),
                             float(ovals[i, 0]), float(ovals[i, 1]))
    if order > 1:
        pos, nb = lay["longest"]
        okeys = np.zeros(nb, np.uint64)
        ovals = np.zeros(nb, np.float32)
        for words, (lp, _) in grams[order - 1].items():
            ids = [vocab.get(w, 0) for w in words]
            key = _chain_key(ids[-1], reversed(ids[:-1]))
            if key == 0:
                key = 1

            def put(i, lp=lp):
                ovals[i] = lp
            _table_insert(okeys, int(key % nb), key, put)
        for i in range(nb):
            struct.pack_into("<Qf", blob, pos + 12 * i, int(okeys[i]),
                             float(ovals[i]))
    with open(out_path, "wb") as f:
        f.write(bytes(blob))
        if include_vocab_strings:
            by_id = sorted(vocab.items(), key=lambda kv: kv[1])
            if not any(wid == 0 for _, wid in by_id):
                f.write(b"<unk>\0")
            for w, _ in by_id:
                f.write(w.encode("utf-8") + b"\0")
    return vocab


# ------------------------------------------------------------------ #
# reader
# ------------------------------------------------------------------ #


class State(object):
    """kenlm.State analogue: context word ids (newest last) + the
    backoff log10 weights of the context n-grams (index j = backoff of
    the (j+1)-length context)."""
    __slots__ = ("words", "backoffs")

    def __init__(self):
        self.words = ()
        self.backoffs = ()

    def __eq__(self, other):
        return self.words == other.words

    def __hash__(self):
        return hash(self.words)


class NGramModelBase(object):
    """Shared kenlm query-API subset over any backend exposing
    `order`, `word_id(word)`, `_uni` ((V+1, 2) prob/backoff array) and
    `_lookup(word_id, context_ids)` (→ (prob, backoff) | None)."""

    def NullContextWrite(self, state):
        state.words = ()
        state.backoffs = ()

    def BeginSentenceWrite(self, state):
        sid = self.word_id("<s>")
        bo = float(self._uni[sid][1]) if sid else 0.0
        state.words = (sid,)
        state.backoffs = (bo,)

    def BaseScore(self, in_state, word, out_state):
        """log10 P(word | in_state), writing the successor state."""
        wid = self.word_id(word)
        ctx = in_state.words                        # oldest→newest
        # longest match: try full context, shrink from the left
        prob = float(self._uni[wid][0])
        new_bos = [float(self._uni[wid][1])]
        matched = 0                                  # context words used
        for use in range(1, len(ctx) + 1):
            hit = self._lookup(wid, ctx[len(ctx) - use:])
            if hit is None:
                break
            prob, bo = hit
            matched = use
            if use + 1 < self.order:
                new_bos.append(bo)
        # backoff penalties of the unmatched longer contexts
        for j in range(matched, len(ctx)):
            prob += in_state.backoffs[j]
        # successor state truncates to the matched length (kenlm's
        # independent-left rule: if (ctx_m, w) is absent, no higher-order
        # n-gram can extend it, so longer context words are dead weight)
        keep = min(matched + 1, self.order - 1) if self.order > 1 else 0
        nw = (ctx + (wid,))[len(ctx) + 1 - keep:] if keep else ()
        out_state.words = nw
        out_state.backoffs = tuple(new_bos[:keep])
        return prob

    def score(self, sentence, bos=True, eos=True):
        """Full-sentence log10 score (kenlm.Model.score parity)."""
        st = State()
        if bos:
            self.BeginSentenceWrite(st)
        else:
            self.NullContextWrite(st)
        total = 0.0
        for w in sentence.split():
            nxt = State()
            total += self.BaseScore(st, w, nxt)
            st = nxt
        if eos:
            nxt = State()
            total += self.BaseScore(st, "</s>", nxt)
        return total


class ProbingModel(NGramModelBase):
    """mmap reader for PROBING-format KenLM binaries with the kenlm
    query-API subset the scorers use."""

    def __init__(self, path):
        self._mm = np.memmap(path, dtype=np.uint8, mode="r")
        head = bytes(self._mm[:_SANITY_SIZE].tobytes())
        if not head.startswith(MAGIC[:len(MAGIC) - 2]):
            raise ValueError(f"{path}: not a KenLM binary (bad magic)")
        zero, one, mhalf, one_w, max_w = struct.unpack_from(
            "<fffII", head, 56)
        if (zero, one, mhalf) != (0.0, 1.0, -0.5):
            raise ValueError(f"{path}: sanity floats mismatch "
                             "(endianness or layout incompatibility)")
        order, mult, mtype, has_vocab, sversion = struct.unpack_from(
            "<B3xfi?3xI", self._mm.tobytes()[
                _SANITY_SIZE:_SANITY_SIZE + _FIXED_SIZE], 0)
        if mtype not in (MODEL_PROBING,):
            names = {1: "REST_PROBING", 2: "TRIE", 3: "QUANT_TRIE",
                     4: "ARRAY_TRIE", 5: "QUANT_ARRAY_TRIE"}
            raise ValueError(
                f"{path}: model_type={names.get(mtype, mtype)} — "
                "ProbingModel reads PROBING binaries only (use "
                "load_klm(), which also dispatches TRIE)")
        self.order = int(order)
        self.multiplier = float(mult)
        counts = struct.unpack_from(
            "<%dQ" % order, self._mm.tobytes()[
                _SANITY_SIZE + _FIXED_SIZE:
                _SANITY_SIZE + _FIXED_SIZE + 8 * order], 0)
        self.counts = [int(c) for c in counts]
        lay = _layout(self.order, self.counts, self.multiplier)
        if lay["end"] > len(self._mm):
            raise ValueError(f"{path}: truncated (layout wants "
                             f"{lay['end']} bytes, file has "
                             f"{len(self._mm)})")
        raw = self._mm
        vb = lay["vocab_buckets"]
        vt = np.frombuffer(raw, np.uint8,
                           12 * vb, lay["vocab_table"])
        self._vkeys = vt.reshape(vb, 12)[:, :8].copy().view(
            np.uint64).reshape(vb)
        self._vvals = vt.reshape(vb, 12)[:, 8:].copy().view(
            np.uint32).reshape(vb)
        self._uni = np.frombuffer(
            raw, np.float32, 2 * (self.counts[0] + 1),
            lay["unigram"]).reshape(-1, 2)
        self._middle = []
        for pos, nb in lay["middle"]:
            mt = np.frombuffer(raw, np.uint8, 16 * nb, pos).reshape(nb, 16)
            self._middle.append((
                mt[:, :8].copy().view(np.uint64).reshape(nb),
                mt[:, 8:].copy().view(np.float32).reshape(nb, 2)))
        pos, nb = lay["longest"]
        if nb:
            lt = np.frombuffer(raw, np.uint8, 12 * nb, pos).reshape(nb, 12)
            self._longest = (lt[:, :8].copy().view(np.uint64).reshape(nb),
                             lt[:, 8:].copy().view(np.float32).reshape(nb))
        else:
            self._longest = (np.zeros(0, np.uint64),
                             np.zeros(0, np.float32))
        self._vocab_cache = {}

    # ---------------- vocab ----------------
    def word_id(self, word):
        wid = self._vocab_cache.get(word)
        if wid is not None:
            return wid
        if word in ("<unk>", "<UNK>"):
            self._vocab_cache[word] = 0
            return 0
        h = murmur64a(word.encode("utf-8"))
        if h == 0:
            h = 1
        n = len(self._vkeys)
        i = int(h % n)
        wid = 0
        while True:
            k = int(self._vkeys[i])
            if k == h:
                wid = int(self._vvals[i])
                break
            if k == 0:
                break
            i = (i + 1) % n
        self._vocab_cache[word] = wid
        return wid

    def __contains__(self, word):
        return self.word_id(word) != 0

    # ---------------- tables ----------------
    def _find(self, keys, key):
        n = len(keys)
        if n == 0:
            return -1
        i = int(key % n)
        while True:
            k = int(keys[i])
            if k == key:
                return i
            if k == 0:
                return -1
            i = (i + 1) % n

    def _lookup(self, word_id, context_ids):
        """(prob, backoff) of the (len(context)+1)-gram or None.
        context_ids ordered oldest→newest."""
        n = 1 + len(context_ids)
        key = _chain_key(word_id, reversed(context_ids))
        if key == 0:
            key = 1
        if n == 1:
            pb = self._uni[word_id]
            return float(pb[0]), float(pb[1])
        if n == self.order:
            keys, vals = self._longest
            i = self._find(keys, key)
            return None if i < 0 else (float(vals[i]), 0.0)
        keys, vals = self._middle[n - 2]
        i = self._find(keys, key)
        return None if i < 0 else (float(vals[i, 0]), float(vals[i, 1]))


def load_klm(path):
    """Open a KenLM binary of either supported format (PROBING or TRIE)
    by its model_type header field."""
    with open(path, "rb") as f:
        head = f.read(_SANITY_SIZE + _FIXED_SIZE)
    if not head.startswith(MAGIC[:len(MAGIC) - 2]):
        raise ValueError(f"{path}: not a KenLM binary (bad magic)")
    mtype = struct.unpack_from("<B3xfi?3xI", head, _SANITY_SIZE)[2]
    if mtype == MODEL_PROBING:
        return ProbingModel(path)
    if mtype == MODEL_TRIE:
        from masr_tpu_torch.decoders.klm_trie import TrieModel
        return TrieModel(path)
    names = {1: "REST_PROBING", 3: "QUANT_TRIE",
             4: "ARRAY_TRIE", 5: "QUANT_ARRAY_TRIE"}
    raise ValueError(
        f"{path}: model_type={names.get(mtype, mtype)} — only PROBING "
        "and (non-quantized, non-array) TRIE binaries are supported; "
        "rebuild with KenLM build_binary probing/trie, or use an ARPA LM")
