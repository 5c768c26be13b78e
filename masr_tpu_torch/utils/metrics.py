"""Error rates (port of masr_tpu/utils/metrics.py) with the port's own
edit distance, so no Levenshtein package is needed.

cer: character edit distance / reference length (spaces removed).
wer: word edit distance / reference words (words mapped to private-use
code points, as the reference does).
"""


def edit_distance(ref, hyp) -> int:
    """Levenshtein distance of two sequences (one row of the table)."""
    prev = list(range(len(hyp) + 1))
    for i, r in enumerate(ref, 1):
        cur = [i] + [0] * len(hyp)
        for j, h in enumerate(hyp, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (r != h))
        prev = cur
    return prev[-1]


def cer(reference: str, hypothesis: str, ignore_case: bool = False,
        remove_space: bool = True) -> float:
    if ignore_case:
        reference, hypothesis = reference.lower(), hypothesis.lower()
    if remove_space:
        reference = reference.replace(" ", "")
        hypothesis = hypothesis.replace(" ", "")
    if len(reference) == 0:
        raise ValueError("empty reference string in cer()")
    return edit_distance(reference, hypothesis) / len(reference)


def wer(reference: str, hypothesis: str, ignore_case: bool = False,
        delimiter: str = " ") -> float:
    if ignore_case:
        reference, hypothesis = reference.lower(), hypothesis.lower()
    ref_words = reference.split(delimiter)
    hyp_words = hypothesis.split(delimiter)
    vocab = {}

    def to_chars(words):
        return "".join(vocab.setdefault(w, chr(0xE000 + len(vocab)))
                       for w in words)

    return edit_distance(to_chars(ref_words), to_chars(hyp_words)) / \
        len(ref_words)
