"""ctypes loader and builder of the native CTC prefix beam search
(port of masr_tpu/decoders/native/__init__.py; ctc_decoders.cc is a copy of
masr_tpu's source).

The shared library is built with `g++` at first use into
`build/decoders/ctc_decoders-<hash>.so` at the repository root, the hash
taken over the source and the flags (as ops/cuda/build.py does for the
CUDA kernels), so an edited source never loads a stale library and nothing
is written beside the source. A failed build raises; beam_search.py then
falls back to the Python engine.
"""
import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "ctc_decoders.cc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    _DIR))), "build", "decoders")
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()


def library_path():
    """→ path of the shared library for this source and these flags."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"ctc_decoders-{digest.hexdigest()[:12]}.so")


def build(force=False):
    """Compile ctc_decoders.cc unless built → the library's path."""
    out = library_path()
    if os.path.exists(out) and not force:
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, _SRC], check=True,
                   capture_output=True)
    os.replace(tmp, out)                # atomic: concurrent builds agree
    return out


def _load():
    lib = ctypes.CDLL(build())
    lib.masr_scorer_create.restype = ctypes.c_void_p
    lib.masr_scorer_create.argtypes = [ctypes.c_char_p, ctypes.c_double,
                                       ctypes.c_double]
    lib.masr_scorer_is_character_based.restype = ctypes.c_int
    lib.masr_scorer_is_character_based.argtypes = [ctypes.c_void_p]
    lib.masr_scorer_destroy.argtypes = [ctypes.c_void_p]
    lib.masr_decoder_create.restype = ctypes.c_void_p
    lib.masr_decoder_create.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_void_p]
    lib.masr_decoder_reset.argtypes = [ctypes.c_void_p]
    lib.masr_decoder_step.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_float),
                                      ctypes.c_int, ctypes.c_int]
    lib.masr_decoder_result.restype = ctypes.c_int
    lib.masr_decoder_result.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_int),
                                        ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_double)]
    lib.masr_decoder_nbest.restype = ctypes.c_int
    lib.masr_decoder_nbest.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_int),
                                       ctypes.POINTER(ctypes.c_int),
                                       ctypes.POINTER(ctypes.c_double),
                                       ctypes.c_int]
    lib.masr_decoder_destroy.argtypes = [ctypes.c_void_p]
    return lib


_lib = None


def get_lib():
    global _lib
    with _lock:
        if _lib is None:
            _lib = _load()
        return _lib


class NativeScorer(object):
    def __init__(self, alpha, beta, arpa_path):
        self._lib = get_lib()
        self.handle = self._lib.masr_scorer_create(
            arpa_path.encode("utf-8"), float(alpha), float(beta))
        if not self.handle:
            raise RuntimeError(f"failed to load ARPA LM: {arpa_path}")

    @property
    def is_character_based(self):
        return bool(self._lib.masr_scorer_is_character_based(self.handle))

    def __del__(self):
        if getattr(self, "handle", None):
            self._lib.masr_scorer_destroy(self.handle)
            self.handle = None


class NativeDecoder(object):
    """Stateful prefix-beam-search stream over one utterance."""

    def __init__(self, vocab_list, blank_id=0, beam_size=300,
                 cutoff_prob=0.99, cutoff_top_n=40, scorer=None):
        self._lib = get_lib()
        self.vocab_list = vocab_list
        self._scorer = scorer  # keep alive
        space_id = vocab_list.index("<space>") if "<space>" in vocab_list \
            else -1
        joined = "\n".join(vocab_list).encode("utf-8")
        self.handle = self._lib.masr_decoder_create(
            joined, len(vocab_list), int(blank_id), int(space_id),
            int(beam_size), float(cutoff_prob), int(cutoff_top_n),
            scorer.handle if scorer is not None else None)

    def reset(self):
        self._lib.masr_decoder_reset(self.handle)

    def step(self, probs):
        probs = np.ascontiguousarray(probs, dtype=np.float32)
        T, V = probs.shape
        self._lib.masr_decoder_step(
            self.handle, probs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            T, V)

    def result(self):
        max_out = 8192
        out = (ctypes.c_int * max_out)()
        score = ctypes.c_double()
        n = self._lib.masr_decoder_result(self.handle, out, max_out,
                                          ctypes.byref(score))
        ids = [out[i] for i in range(n)]
        text = "".join(" " if self.vocab_list[i] == "<space>"
                       else self.vocab_list[i] for i in ids)
        return float(score.value), text

    def next(self, probs):
        """Chunk decode: advance and return the current best (score, text)."""
        self.step(probs)
        return self.result()

    def result_nbest(self, n, max_len=8192):
        out = (ctypes.c_int * (n * max_len))()
        lens = (ctypes.c_int * n)()
        scores = (ctypes.c_double * n)()
        count = self._lib.masr_decoder_nbest(self.handle, n, out, lens,
                                             scores, max_len)
        results = []
        for i in range(count):
            ids = [out[i * max_len + t] for t in range(lens[i])]
            results.append((float(scores[i]), ids))
        return results

    def __del__(self):
        if getattr(self, "handle", None):
            self._lib.masr_decoder_destroy(self.handle)
            self.handle = None
