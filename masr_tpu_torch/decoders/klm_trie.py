"""(Copy of masr_tpu/decoders/klm_trie.py.)

KenLM TRIE-format binary language models, natively (no `kenlm`
package): an mmap reader + an ARPA→trie writer (VERDICT r3 item 8 —
probing landed in r3, this completes binary interop in kind).

The trie is KenLM's compact format (`build_binary trie`): a
reversed-suffix trie over n-grams. Scoring P(w | c1…ck) starts at the
unigram record of w and descends through the context words NEWEST
first — the entry reached at depth d holds the prob/backoff of the
(d)-gram "c_{k-d+2} … c_k w". Layout re-derived from the KenLM sources'
documented structure (lm/binary_format.{hh,cc}, lm/vocab.{hh,cc}
SortedVocabulary, lm/trie.{hh,cc} Unigram/BitPackedMiddle/
BitPackedLongest, lm/quantize.hh DontQuantize, lm/bhiksha.hh
DontBhiksha, util/bit_packing.hh — LGPL headers; layout re-derived, no
code copied):

  [Sanity header + FixedWidthParameters(model_type=TRIE=2,
   search_version=1) + uint64 counts[order]]      (as probing)
  [SortedVocabulary: uint64 count, then count sorted uint64
   MurmurHash64A word hashes — word id = sorted index + 1, <unk> = 0]
  [Unigram: (counts[0] + 2) × {float prob, float backoff, uint64 next}
   — id-indexed; next = begin index of the word's child block in the
   first middle level; entry id+1's next is the block end]
  [per middle order 2..n-1: uint64 max_next, then a bit-packed array of
   (counts[o-1] + 1) entries × (word_bits + 31-bit prob + 32-bit
   backoff + next_bits): word_bits = bits(counts[0] + 1), prob stored
   sign-stripped (always ≤ 0), next_bits = bits(max_next); the +1
   terminal entry carries the final block end]
  [longest order: bit-packed (word_bits + 31-bit prob) entries]

Bit packing mirrors util::ReadInt57/ReadNonPositiveFloat31: a field at
bit offset b = (little-endian uint64 loaded at byte b//8) >> (b%8),
masked; each section is padded with 8 tail bytes so the last load stays
in bounds. Within a child block entries are sorted by word id (binary
search descent).

Round-trip (write_trie → TrieModel) is tested against the in-repo ARPA
scorer AND the probing reader on the same ARPA
(tests/test_klm_binary.py). As with probing, byte-level compatibility
with binaries real KenLM wrote follows the sources by construction but
cannot be verified in this image (no kenlm build, no .klm reachable) —
the uncertain spots are the exact SortedVocabulary id convention and
the 8-byte DontBhiksha region (interpreted here as the max_next word);
see docs/design_deviations.md #6.
"""
import struct

import numpy as np

from masr_tpu_torch.decoders.klm_probing import (MAGIC, MODEL_TRIE,
                                                 NGramModelBase, State,
                                                 _FIXED_SIZE, _SANITY_SIZE,
                                                 _align8, _read_arpa,
                                                 murmur64a)

__all__ = ["TrieModel", "write_trie", "State"]


def _bits(max_value):
    """util::RequiredBits: bits to hold values in [0, max_value]."""
    return max(1, int(max_value).bit_length())


class _BitWriter(object):
    def __init__(self, total_bits):
        self.buf = bytearray((total_bits + 7) // 8 + 8)

    def write(self, bit_off, n_bits, value):
        byte, sh = bit_off >> 3, bit_off & 7
        cur = int.from_bytes(self.buf[byte:byte + 8], "little")
        cur |= (int(value) & ((1 << n_bits) - 1)) << sh
        self.buf[byte:byte + 8] = cur.to_bytes(8, "little")


def _read_bits(mm, base, bit_off, n_bits):
    byte = base + (bit_off >> 3)
    cur = int.from_bytes(bytes(mm[byte:byte + 8]), "little")
    return (cur >> (bit_off & 7)) & ((1 << n_bits) - 1)


def _prob31(f):
    """float ≤ 0 → 31 sign-stripped float32 bits (ReadNonPositiveFloat31
    inverse)."""
    return struct.unpack("<I", struct.pack("<f", f))[0] & 0x7FFFFFFF


def _unprob31(bits):
    return struct.unpack("<f", struct.pack("<I", bits | 0x80000000))[0]


def _f32bits(f):
    return struct.unpack("<I", struct.pack("<f", f))[0]


def _unf32(bits):
    return struct.unpack("<f", struct.pack("<I", bits))[0]


# ------------------------------------------------------------------ #
# writer
# ------------------------------------------------------------------ #


def write_trie(arpa_path, out_path, multiplier=1.5):
    """Build a TRIE-format .klm from an ARPA file → vocab (word → id).
    Requires suffix closure: every n-gram's length-(n−1) suffix must be
    present as an (n−1)-gram (standard ARPA output guarantees this)."""
    order, grams = _read_arpa(arpa_path)
    unigrams = grams[0]
    # SortedVocabulary ids: words (except <unk>) sorted by MurmurHash64A
    words = [w for (w,) in unigrams if w not in ("<unk>", "<UNK>")]
    hashes = sorted((murmur64a(w.encode("utf-8")), w) for w in words)
    vocab = {w: i + 1 for i, (_, w) in enumerate(hashes)}
    for (w,) in unigrams:
        if w in ("<unk>", "<UNK>"):
            vocab[w] = 0
    counts = [len(g) for g in grams]
    V = counts[0]

    # tree over REVERSED n-grams: path = (w, c_k, c_{k-1}, …)
    root = {}          # wid → node; node = [prob, backoff, {wid → node}]
    uni_vals = np.zeros((V + 2, 2), np.float32)
    uni_vals[:, 0] = -100.0
    for (w,), (lp, bo) in unigrams.items():
        wid = vocab[w]
        uni_vals[wid] = (lp, bo)
        root[wid] = [lp, bo, {}]
    for wid in range(V + 1):
        root.setdefault(wid, [-100.0, 0.0, {}])
    for o in range(2, order + 1):
        for wrds, (lp, bo) in grams[o - 1].items():
            ids = [vocab.get(w, 0) for w in wrds]
            node = root[ids[-1]]
            path = list(reversed(ids[:-1]))      # newest context first
            # intermediates are this n-gram's suffixes — inserted by the
            # previous (lower-order) pass when the ARPA is suffix-closed
            for cid in path[:-1]:
                node = node[2].get(cid)
                if node is None:
                    raise ValueError(
                        f"ARPA lacks suffix closure at {wrds!r}")
            child = node[2].get(path[-1])
            if child is None:
                child = node[2][path[-1]] = [None, 0.0, {}]
            child[0], child[1] = lp, bo

    # level-by-level layout: children blocks in parent-entry order,
    # sorted by word id within each block
    levels = [[] for _ in range(order + 1)]   # levels[d] = [(wid, node)]
    levels[1] = [(wid, root.get(wid, [None, 0.0, {}]))
                 for wid in range(V + 1)]
    for d in range(1, order):
        for _, node in levels[d]:
            levels[d + 1].extend(sorted(node[2].items()))

    # section sizes
    word_bits = _bits(V + 1)
    header = _align8(_SANITY_SIZE + _FIXED_SIZE + 8 * order)
    vocab_size = 8 + 8 * len(hashes)
    pos = _align8(header + vocab_size)
    uni_pos = pos
    pos += 16 * (V + 2)
    mids = []
    for o in range(2, order):
        n_entries = len(levels[o])
        max_next = len(levels[o + 1])
        next_bits = _bits(max_next)
        total = word_bits + 63 + next_bits
        mids.append(dict(pos=pos, entries=n_entries, next_bits=next_bits,
                         total=total, max_next=max_next))
        pos += 8 + (((n_entries + 1) * total + 7) // 8 + 8)
        pos = _align8(pos)
    lon_pos = pos
    lon_total = word_bits + 31
    n_lon = len(levels[order]) if order > 1 else 0
    pos += (n_lon * lon_total + 7) // 8 + 8

    blob = bytearray(pos)
    s = bytearray(_SANITY_SIZE)
    s[:len(MAGIC)] = MAGIC
    struct.pack_into("<fffII", s, 56, 0.0, 1.0, -0.5, 1, 0xFFFFFFFF)
    struct.pack_into("<Q", s, 80, 1)
    blob[:_SANITY_SIZE] = s
    struct.pack_into("<B3xfi?3xI", blob, _SANITY_SIZE, order, multiplier,
                     MODEL_TRIE, False, 1)
    struct.pack_into("<%dQ" % order, blob, _SANITY_SIZE + _FIXED_SIZE,
                     *counts)
    struct.pack_into("<Q", blob, header, len(hashes))
    for i, (h, _) in enumerate(hashes):
        struct.pack_into("<Q", blob, header + 8 + 8 * i, h)

    # unigram records with next pointers into level 2
    nxt = 0
    for wid in range(V + 1):
        node = levels[1][wid][1]
        struct.pack_into("<ffQ", blob, uni_pos + 16 * wid,
                         float(uni_vals[wid, 0]), float(uni_vals[wid, 1]),
                         nxt)
        nxt += len(node[2])
    struct.pack_into("<ffQ", blob, uni_pos + 16 * (V + 1), 0.0, 0.0, nxt)

    # middle levels
    for o in range(2, order):
        m = mids[o - 2]
        struct.pack_into("<Q", blob, m["pos"], m["max_next"])
        bw = _BitWriter((m["entries"] + 1) * m["total"])
        nxt = 0
        for i, (wid, node) in enumerate(levels[o]):
            off = i * m["total"]
            bw.write(off, word_bits, wid)
            prob = node[0] if node[0] is not None else -100.0
            bw.write(off + word_bits, 31, _prob31(prob))
            bw.write(off + word_bits + 31, 32, _f32bits(node[1]))
            bw.write(off + word_bits + 63, m["next_bits"], nxt)
            nxt += len(node[2])
        off = m["entries"] * m["total"]
        bw.write(off + word_bits + 63, m["next_bits"], nxt)
        blob[m["pos"] + 8:m["pos"] + 8 + len(bw.buf)] = bw.buf

    # longest level (no backoff, no next)
    if order > 1:
        bw = _BitWriter(n_lon * lon_total)
        for i, (wid, node) in enumerate(levels[order]):
            off = i * lon_total
            bw.write(off, word_bits, wid)
            bw.write(off + word_bits, 31, _prob31(node[0]))
        blob[lon_pos:lon_pos + len(bw.buf)] = bw.buf

    with open(out_path, "wb") as f:
        f.write(bytes(blob))
    return vocab


# ------------------------------------------------------------------ #
# reader
# ------------------------------------------------------------------ #


class TrieModel(NGramModelBase):
    """mmap reader for (non-quantized, non-array) TRIE KenLM binaries
    with the kenlm query-API subset the scorers use."""

    def __init__(self, path):
        self._mm = np.memmap(path, dtype=np.uint8, mode="r")
        head = bytes(self._mm[:_SANITY_SIZE].tobytes())
        if not head.startswith(MAGIC[:len(MAGIC) - 2]):
            raise ValueError(f"{path}: not a KenLM binary (bad magic)")
        raw = bytes(self._mm[:_SANITY_SIZE + _FIXED_SIZE].tobytes())
        order, _mult, mtype, _hv, _sv = struct.unpack_from(
            "<B3xfi?3xI", raw, _SANITY_SIZE)
        if mtype != MODEL_TRIE:
            raise ValueError(f"{path}: model_type={mtype} — TrieModel "
                             "reads TRIE binaries only (use load_klm())")
        self.order = int(order)
        counts = struct.unpack_from("<%dQ" % order, bytes(self._mm[
            _SANITY_SIZE + _FIXED_SIZE:
            _SANITY_SIZE + _FIXED_SIZE + 8 * order].tobytes()), 0)
        self.counts = [int(c) for c in counts]
        V = self.counts[0]
        header = _align8(_SANITY_SIZE + _FIXED_SIZE + 8 * order)
        n_hash = struct.unpack_from(
            "<Q", bytes(self._mm[header:header + 8].tobytes()))[0]
        self._vhash = np.frombuffer(self._mm, np.uint64, int(n_hash),
                                    header + 8)
        pos = _align8(header + 8 + 8 * int(n_hash))
        uni = np.frombuffer(self._mm, np.uint8, 16 * (V + 2), pos)
        uni = uni.reshape(V + 2, 16)
        self._uni = uni[:, :8].copy().view(np.float32).reshape(V + 2, 2)
        self._uni_next = uni[:, 8:].copy().view(np.uint64).reshape(V + 2)
        pos += 16 * (V + 2)
        self._word_bits = _bits(V + 1)
        self._mids = []
        for o in range(2, self.order):
            n_entries = self.counts[o - 1]
            max_next = struct.unpack_from(
                "<Q", bytes(self._mm[pos:pos + 8].tobytes()))[0]
            next_bits = _bits(int(max_next))
            total = self._word_bits + 63 + next_bits
            self._mids.append(dict(base=pos + 8, entries=n_entries,
                                   next_bits=next_bits, total=total))
            pos += 8 + (((n_entries + 1) * total + 7) // 8 + 8)
            pos = _align8(pos)
        self._lon = dict(base=pos, entries=self.counts[-1]
                         if self.order > 1 else 0,
                         total=self._word_bits + 31)
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
        i = int(np.searchsorted(self._vhash, np.uint64(h)))
        wid = i + 1 if i < len(self._vhash) \
            and int(self._vhash[i]) == h else 0
        self._vocab_cache[word] = wid
        return wid

    def __contains__(self, word):
        return self.word_id(word) != 0

    # ---------------- trie descent ----------------
    def _word_at(self, lvl, idx):
        return _read_bits(self._mm, lvl["base"], idx * lvl["total"],
                          self._word_bits)

    def _bsearch(self, lvl, begin, end, wid):
        lo, hi = begin, end
        while lo < hi:
            mid = (lo + hi) // 2
            w = self._word_at(lvl, mid)
            if w == wid:
                return mid
            if w < wid:
                lo = mid + 1
            else:
                hi = mid
        return -1

    def _lookup(self, word_id, context_ids):
        """(prob, backoff) of the (len(context)+1)-gram or None.
        context_ids ordered oldest→newest; descent goes newest first."""
        n = 1 + len(context_ids)
        if n == 1:
            pb = self._uni[word_id]
            return float(pb[0]), float(pb[1])
        begin = int(self._uni_next[word_id])
        end = int(self._uni_next[word_id + 1])
        for d, cid in enumerate(reversed(context_ids)):
            depth = d + 2                           # level being entered
            if begin >= end:
                return None
            if depth == self.order:
                lvl = self._lon
                i = self._bsearch(lvl, begin, end, cid)
                if i < 0:
                    return None
                off = i * lvl["total"] + self._word_bits
                return _unprob31(_read_bits(self._mm, lvl["base"], off,
                                            31)), 0.0
            lvl = self._mids[depth - 2]
            i = self._bsearch(lvl, begin, end, cid)
            if i < 0:
                return None
            off = i * lvl["total"] + self._word_bits
            if depth == n:
                prob = _unprob31(_read_bits(self._mm, lvl["base"], off, 31))
                bo = _unf32(_read_bits(self._mm, lvl["base"], off + 31, 32))
                return prob, bo
            begin = _read_bits(self._mm, lvl["base"], off + 63,
                               lvl["next_bits"])
            end = _read_bits(self._mm, lvl["base"],
                             (i + 1) * lvl["total"] + self._word_bits + 63,
                             lvl["next_bits"])
        return None
