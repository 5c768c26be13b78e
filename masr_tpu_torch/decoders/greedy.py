"""CTC greedy decoding (port of masr_tpu/decoders/greedy.py:20-81: offline,
batch and the streaming chunk decoder).

Scores come from the probs (the reference swaps its two carry lists and
reports index-derived scores; masr_tpu implements the intended semantics
and the port follows masr_tpu).
"""
import numpy as np


def _collapse(max_index, max_prob, vocab_list, blank_id=0):
    """Collapse repeats → drop blanks → map to text + mean prob score."""
    tokens, probs = [], []
    prev = -1
    for idx, p in zip(max_index, max_prob):
        if idx != prev and idx != blank_id:
            tokens.append(int(idx))
            probs.append(float(p))
        prev = idx
    text = "".join(" " if vocab_list[t] == "<space>" else vocab_list[t]
                   for t in tokens)
    score = float(np.mean(probs)) * 100 if probs else 0.0
    return score, text


def greedy_decoder(probs_seq, vocab_list, blank_id=0):
    """(T, V) softmax probs → (score, text)."""
    probs_seq = np.asarray(probs_seq)
    return _collapse(probs_seq.argmax(axis=1), probs_seq.max(axis=1),
                     vocab_list, blank_id)


def greedy_decoder_batch(probs_split, vocab_list, blank_id=0, lens=None):
    """List/array of per-utterance probs → list of (score, text)."""
    results = []
    for i, probs in enumerate(probs_split):
        p = np.asarray(probs)
        if lens is not None:
            p = p[: int(lens[i])]
        results.append(greedy_decoder(p, vocab_list, blank_id))
    return results


class GreedyChunkDecoder(object):
    """Stateful streaming greedy decode: accumulates per-chunk argmax and
    re-collapses the whole prefix each call (masr_tpu's carry semantics)."""

    def __init__(self, vocab_list, blank_id=0):
        self.vocab_list = vocab_list
        self.blank_id = blank_id
        self.reset()

    def reset(self):
        self._max_index = []
        self._max_prob = []

    def decode_chunk(self, probs_chunk):
        """(T_chunk, V) softmax probs → (score, text) for the full prefix."""
        p = np.asarray(probs_chunk)
        return self.decode_chunk_ids(p.argmax(axis=1), p.max(axis=1))

    def decode_chunk_ids(self, ids, max_probs):
        """Advance the carry with per-frame (argmax id, max prob) computed
        on the device (the (T, V) probs never come back)."""
        self._max_index.extend(np.asarray(ids).ravel().tolist())
        self._max_prob.extend(np.asarray(max_probs).ravel().tolist())
        return _collapse(self._max_index, self._max_prob, self.vocab_list,
                         self.blank_id)
