"""The port's host decoders (masr_tpu_torch.decoders: beam_search, scorer,
klm_probing, klm_trie, native) against masr_tpu's on the same probs.

- Native against native and Python against Python: same texts, scores
  within 1e-9 (the same source and the same arithmetic), offline, n-best,
  batch and decode_chunk in pieces.
- LM fusion through an ARPA the test writes, hotwords, KenLM binaries:
  the PROBING and TRIE files both packages write are byte-identical and
  score alike.
- The cases of tests/test_decoders.py, test_native_decoder.py,
  test_hotwords.py, test_klm_binary.py and test_lm_migration.py that need
  no data from outside the repository, on the port.
"""
import itertools
import os
import sys
import types

import numpy as np
import pytest
from test_torch_threads import one_torch_thread  # noqa: F401

VOCAB = ["<blank>", "<unk>", "a", "b", "c", "<space>", "<eos>"]
ZH = ["<blank>", "你", "好", "天", "气", "小", "明"]
SCORE_ATOL = 1e-9

ARPA_AB = """\\data\\
ngram 1=4
ngram 2=1

\\1-grams:
-5.0\t<unk>
-0.8\ta\t0.0
-0.8\tb\t0.0
-3.0\tc

\\2-grams:
-0.05\ta b

\\end\\
"""

ARPA_ZH = """\\data\\
ngram 1=6
ngram 2=4

\\1-grams:
-0.4\t你\t-0.3
-0.5\t好\t-0.3
-2.2\t天\t-0.3
-1.0\t气\t-0.3
-3.0\t<unk>
-0.4\t<s>\t-0.3

\\2-grams:
-0.05\t你 好
-2.6\t你 天
-0.4\t好 你
-0.5\t好 气

\\end\\
"""


def _rand_probs(T, seed, V=len(VOCAB), scale=2.0):
    rs = np.random.RandomState(seed)
    logits = rs.standard_normal((T, V)).astype(np.float32) * scale
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


def _probs_from_ids(ids, V=len(VOCAB), peak=0.9):
    p = np.full((len(ids), V), (1 - peak) / (V - 1), np.float32)
    for t, i in enumerate(ids):
        p[t, i] = peak
    return p


def _zh_ambiguous():
    """你, then 好 against 天 tilted toward 天, then 气
    (tests/test_hotwords.py)."""
    probs = np.full((6, len(ZH)), 1e-6, np.float32)
    probs[0, 1] = 0.9
    probs[1, 0] = 0.9
    probs[2, 2] = 0.40
    probs[2, 3] = 0.52
    probs[3, 0] = 0.9
    probs[4, 4] = 0.9
    probs[5, 0] = 0.9
    return probs / probs.sum(axis=1, keepdims=True)


def _pair(**kw):
    """The port's and masr_tpu's BeamSearchDecoder with the same args."""
    from masr_tpu.decoders.beam_search import BeamSearchDecoder as Ref
    from masr_tpu_torch.decoders.beam_search import BeamSearchDecoder
    vocab = kw.pop("vocab", VOCAB)
    return BeamSearchDecoder(vocab, **kw), Ref(vocab, **kw)


def _same(got, want):
    assert got[1] == want[1]
    assert abs(got[0] - want[0]) <= SCORE_ATOL, (got, want)


@pytest.fixture(scope="module")
def native_built():
    from masr_tpu_torch.decoders import native
    return native.build()


def test_native_builds_into_build_dir(native_built):
    """The library lands in build/decoders/ under a hash of source and
    flags, never beside the source."""
    from masr_tpu_torch.decoders import native
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        native.__file__)))
    assert os.path.dirname(native_built) == os.path.join(
        os.path.dirname(os.path.dirname(root)), "build", "decoders")
    assert native_built == native.library_path()
    assert not [f for f in os.listdir(os.path.dirname(native.__file__))
                if f.endswith(".so")]


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_offline_equals_masr_tpu(native_built, use_native, seed):
    port, ref = _pair(beam_size=16, use_native=use_native)
    assert port.engine == ("native" if use_native else "python")
    probs = _rand_probs(20, seed)
    _same(port.decode_beam_search_offline(probs),
          ref.decode_beam_search_offline(probs))


@pytest.mark.parametrize("use_native", [True, False])
def test_nbest_equals_masr_tpu(native_built, use_native):
    port, ref = _pair(beam_size=12, use_native=use_native)
    probs = _rand_probs(15, 5)
    got, want = port.decode_nbest(probs, 6), ref.decode_nbest(probs, 6)
    assert [ids for _, ids in got] == [ids for _, ids in want]
    np.testing.assert_allclose([s for s, _ in got], [s for s, _ in want],
                               rtol=0, atol=SCORE_ATOL)


@pytest.mark.parametrize("use_native", [True, False])
def test_batch_equals_masr_tpu(native_built, use_native):
    port, ref = _pair(beam_size=8, num_processes=4, use_native=use_native)
    batch = [_rand_probs(12, s) for s in range(6)]
    for g, w in zip(port.decode_batch_beam_search_offline(batch),
                    ref.decode_batch_beam_search_offline(batch)):
        _same(g, w)


@pytest.mark.parametrize("use_native", [True, False])
def test_decode_chunk_in_pieces_equals_offline(native_built, use_native):
    """decode_chunk over pieces of 3 frames: the offline result, and
    masr_tpu's decode_chunk piece by piece; reset_state restarts."""
    port, ref = _pair(beam_size=16, use_native=use_native)
    probs = _rand_probs(18, 2)
    offline = port.decode_beam_search_offline(probs)
    for i in range(0, 18, 3):
        got = port.decode_chunk(probs[i:i + 3])
        _same(got, ref.decode_chunk(probs[i:i + 3]))
    assert got[1] == offline[1] and abs(got[0] - offline[0]) <= 1e-4
    got_n, want_n = port.nbest_state(4), ref.nbest_state(4)
    assert [i for _, i in got_n] == [i for _, i in want_n]
    port.reset_state()
    fresh, _ = _pair(beam_size=16, use_native=use_native)
    assert port.decode_chunk(probs[:3]) == fresh.decode_chunk(probs[:3])


@pytest.mark.parametrize("use_native", [True, False])
def test_lm_fusion_equals_masr_tpu(native_built, tmp_path, use_native):
    """An ARPA LM flips 'ac' to 'ab' in both packages, engine by engine."""
    p = tmp_path / "lm.arpa"
    p.write_text(ARPA_AB)
    probs = np.array([[0.05, 0.0, 0.9, 0.02, 0.03, 0.0, 0.0],
                      [0.05, 0.0, 0.0, 0.44, 0.51, 0.0, 0.0]], np.float32)
    port, ref = _pair(alpha=1.0, beta=0.0, beam_size=8,
                      language_model_path=str(p), use_native=use_native)
    if use_native:
        assert port._native_scorer is not None
        assert port._native_scorer.is_character_based
    else:
        assert port.scorer is not None and port.scorer.is_character_based
    got = port.decode_beam_search_offline(probs)
    _same(got, ref.decode_beam_search_offline(probs))
    assert got[1] == "ab"
    no_lm, _ = _pair(beam_size=8, use_native=use_native)
    assert no_lm.decode_beam_search_offline(probs)[1] == "ac"
    rand = _rand_probs(16, 7)
    _same(port.decode_beam_search_offline(rand),
          ref.decode_beam_search_offline(rand))


def test_native_lm_equals_python_lm(native_built, tmp_path):
    p = tmp_path / "lm.arpa"
    p.write_text(ARPA_AB)
    nat, _ = _pair(alpha=1.0, beta=0.5, beam_size=8,
                   language_model_path=str(p))
    py, _ = _pair(alpha=1.0, beta=0.5, beam_size=8,
                  language_model_path=str(p), use_native=False)
    probs = _rand_probs(14, 3)
    s_n, t_n = nat.decode_beam_search_offline(probs)
    s_p, t_p = py.decode_beam_search_offline(probs)
    assert t_n == t_p and abs(s_n - s_p) < 1e-4


def test_arpa_scorer_equals_masr_tpu(tmp_path):
    from masr_tpu.decoders.scorer import ArpaLM as RefLM
    from masr_tpu_torch.decoders.scorer import ArpaLM, Scorer
    p = tmp_path / "lm.arpa"
    p.write_text(ARPA_ZH, encoding="utf-8")
    lm, ref = ArpaLM(str(p)), RefLM(str(p))
    assert lm.order == ref.order == 2 and lm.ngrams == ref.ngrams
    words = ["你", "好", "天", "气", "怪"]
    for n in (0, 1, 2):
        for ctx in itertools.product(words, repeat=n):
            for w in words:
                assert lm.log10_cond(list(ctx), w) == \
                    ref.log10_cond(list(ctx), w)
    sc = Scorer(2.0, 0.5, str(p))
    assert sc.is_character_based
    assert abs(sc.score_word(["你"], "好") - (2.0 * -0.05 + 0.5)) < 1e-12


# ---------------------------------------------------------------------- #
# cases of tests/test_decoders.py and test_native_decoder.py, on the port
# ---------------------------------------------------------------------- #
def test_beam_matches_greedy_on_peaked(native_built):
    from masr_tpu_torch.decoders.greedy import greedy_decoder
    probs = _probs_from_ids([2, 2, 0, 3, 0, 4, 4], peak=0.97)
    port, _ = _pair(beam_size=8)
    assert port.decode_beam_search_offline(probs)[1] == \
        greedy_decoder(probs, VOCAB)[1]


@pytest.mark.parametrize("use_native", [True, False])
def test_beam_beats_greedy_on_ambiguous(native_built, use_native):
    p = np.array([[0.6, 0.0, 0.4, 0.0, 0.0, 0.0, 0.0],
                  [0.4, 0.0, 0.6, 0.0, 0.0, 0.0, 0.0]], np.float32)
    port, _ = _pair(beam_size=8, use_native=use_native)
    assert port.decode_beam_search_offline(p)[1] == "a"


def test_batch_decode_threads_equal_singles(native_built):
    port, _ = _pair(beam_size=8, num_processes=4)
    batch = [_probs_from_ids([2, 0, 3]), _probs_from_ids([4])] + \
        [_rand_probs(12, s) for s in range(4)]
    res = port.decode_batch_beam_search_offline(batch)
    assert [t for _, t in res[:2]] == ["ab", "c"]
    assert [t for _, t in res] == \
        [port.decode_beam_search_offline(p)[1] for p in batch]


def test_native_faster_than_python(native_built):
    """The C++ engine beats the Python one several times over at a
    realistic beam (why the component is native)."""
    import time
    V = 200
    vocab = ["<blank>", "<unk>"] + [chr(0x4E00 + i) for i in range(V - 3)] \
        + ["<eos>"]
    probs = _rand_probs(60, 3, V=V)
    nat, _ = _pair(vocab=vocab, beam_size=64, cutoff_top_n=20)
    py, _ = _pair(vocab=vocab, beam_size=64, cutoff_top_n=20,
                  use_native=False)
    t0 = time.perf_counter()
    nat.decode_beam_search_offline(probs)
    t_nat = time.perf_counter() - t0
    t0 = time.perf_counter()
    py.decode_beam_search_offline(probs)
    assert t_nat * 3 < time.perf_counter() - t0


def test_native_build_failure_falls_back_to_python(monkeypatch):
    """When the library will not build, the decoder runs the Python
    engine (masr_tpu's documented fallback) and says so."""
    from masr_tpu_torch.decoders import beam_search, native

    def broken():
        raise OSError("no compiler")

    monkeypatch.setattr(native, "get_lib", broken)
    dec = beam_search.BeamSearchDecoder(VOCAB, beam_size=8)
    assert dec.engine == "python"
    assert dec.decode_beam_search_offline(_probs_from_ids([2, 0, 3]))[1] \
        == "ab"


# ---------------------------------------------------------------------- #
# hotwords (tests/test_hotwords.py)
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("hotwords,want", [(["你好"], "你好气"),
                                           (["小明"], "你天气"),
                                           (["你天明"], "你天气")])
def test_hotwords_equal_masr_tpu(hotwords, want):
    port, ref = _pair(vocab=ZH, beam_size=8, cutoff_top_n=6,
                      hotwords=hotwords, hotword_score=3.0)
    assert port.engine == "python" and port.hotword_scorer is not None
    probs = _zh_ambiguous()
    got = port.decode_beam_search_offline(probs)
    _same(got, ref.decode_beam_search_offline(probs))
    assert got[1] == want
    for i in range(0, len(probs), 2):
        streamed = port.decode_chunk(probs[i:i + 2])
    assert streamed[1] == want


def test_hotword_scorer_equals_masr_tpu():
    from masr_tpu.decoders.scorer import HotwordScorer as Ref
    from masr_tpu_torch.decoders.scorer import HotwordScorer
    a = HotwordScorer(["小明天", "你好"], boost=2.0, match_bonus=1.0)
    b = Ref(["小明天", "你好"], boost=2.0, match_bonus=1.0)
    for text in ("小明", "小明气", "你小明", "小气小明天", "你好你好"):
        ctx = []
        for c in text:
            assert a.delta(ctx, c) == b.delta(ctx, c)
            ctx.append(c)


def test_hotwords_compose_with_lm(tmp_path):
    arpa = ("\\data\\\nngram 1=5\n\n\\1-grams:\n"
            "-0.4\t你\n-0.5\t好\n-0.9\t天\n-0.9\t气\n-3.0\t<unk>\n\n"
            "\\end\\\n")
    p = tmp_path / "lm.arpa"
    p.write_text(arpa, encoding="utf-8")
    port, ref = _pair(vocab=ZH, alpha=0.3, beta=0.0, beam_size=8,
                      cutoff_top_n=6, use_native=False,
                      language_model_path=str(p), hotwords=["你好"],
                      hotword_score=3.0)
    got = port.decode_beam_search_offline(_zh_ambiguous())
    _same(got, ref.decode_beam_search_offline(_zh_ambiguous()))
    assert got[1] == "你好气"


# ---------------------------------------------------------------------- #
# KenLM binaries (tests/test_klm_binary.py, test_lm_migration.py)
# ---------------------------------------------------------------------- #
def _random_arpa(path, order=3, nwords=40, seed=0):
    """A random ARPA with the prefix / suffix closure a real LM has."""
    rs = np.random.RandomState(seed)
    words = [f"w{i}" for i in range(nwords)]
    grams = [{(w,): (float(-1 - 3 * rs.rand()), float(-0.5 * rs.rand()))
              for w in words}]
    grams[0][("<unk>",)] = (-5.0, 0.0)
    grams[0][("<s>",)] = (-2.0, -0.2)
    grams[0][("</s>",)] = (-2.5, 0.0)
    pool = words + ["<s>", "</s>"]
    bi = {}
    for _ in range(nwords * 6):
        bi[(pool[rs.randint(len(pool))], pool[rs.randint(len(pool))])] = (
            float(-1 - 2 * rs.rand()), float(-0.4 * rs.rand()))
    grams.append(bi)
    if order == 3:
        tri, keys = {}, list(bi)
        for _ in range(nwords * 6):
            a, b = keys[rs.randint(len(keys))]
            c = pool[rs.randint(len(pool))]
            if (b, c) in bi:
                tri[(a, b, c)] = (float(-0.5 - 2 * rs.rand()), 0.0)
        grams.append(tri)
    lines = ["\\data\\"] + [f"ngram {n + 1}={len(g)}"
                            for n, g in enumerate(grams)] + [""]
    for n, g in enumerate(grams):
        lines.append(f"\\{n + 1}-grams:")
        for k, (p, bo) in g.items():
            last = n + 1 == len(grams)
            lines.append(f"{p}\t{' '.join(k)}" if last or not bo
                         else f"{p}\t{' '.join(k)}\t{bo}")
        lines.append("")
    path.write_text("\n".join(lines + ["\\end\\", ""]), encoding="utf-8")
    return str(path), words


def _thread(model, ctx, w):
    from masr_tpu_torch.decoders.klm_probing import State
    st = State()
    model.NullContextWrite(st)
    for c in ctx:
        nxt = State()
        model.BaseScore(st, c, nxt)
        st = nxt
    return model.BaseScore(st, w, State())


@pytest.mark.parametrize("fmt", ["probing", "trie"])
@pytest.mark.parametrize("which", ["small", "trigram"])
def test_klm_files_byte_identical_and_scores_equal(tmp_path, fmt, which):
    """Both packages' writers give the same bytes; the port's reader
    scores them as masr_tpu's reader and its ARPA scorer do."""
    from masr_tpu.decoders import klm_probing as ref_probing
    from masr_tpu.decoders import klm_trie as ref_trie
    from masr_tpu.decoders.scorer import ArpaLM
    from masr_tpu_torch.decoders import klm_probing, klm_trie
    if which == "small":
        arpa = tmp_path / "lm.arpa"
        arpa.write_text(ARPA_ZH, encoding="utf-8")
        arpa, words = str(arpa), ["你", "好", "天", "气", "怪"]
    else:
        arpa, words = _random_arpa(tmp_path / "rand.arpa")
    write, ref_write = (klm_probing.write_probing, ref_probing.write_probing) \
        if fmt == "probing" else (klm_trie.write_trie, ref_trie.write_trie)
    ours, theirs = tmp_path / "port.klm", tmp_path / "ref.klm"
    write(arpa, str(ours))
    ref_write(arpa, str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()
    model = klm_probing.load_klm(str(ours))
    ref_model = ref_probing.load_klm(str(theirs))
    assert type(model).__name__ == type(ref_model).__name__ == \
        ("ProbingModel" if fmt == "probing" else "TrieModel")
    lm = ArpaLM(arpa)
    rs = np.random.RandomState(1)
    for _ in range(150):
        ctx = [words[rs.randint(len(words))] for _ in range(rs.randint(4))]
        w = words[rs.randint(len(words))]
        got = _thread(model, ctx, w)
        assert got == _thread(ref_model, ctx, w)
        np.testing.assert_allclose(got, lm.log10_cond(ctx, w), atol=1e-5)


def test_murmur64a_reference_vectors():
    from masr_tpu_torch.decoders.klm_probing import murmur64a
    assert murmur64a(b"") == 0
    assert murmur64a(b"a") == 510903276987443985
    assert murmur64a(b"abc") == 11297775770902552315
    assert murmur64a("你".encode("utf-8")) == 17630163719658166804


def test_kenlm_binary_decodes_with_python_engine(tmp_path):
    """A KenLM binary LM runs through the in-repo reader in the Python
    engine (engine == "python") and decodes as the ARPA it came from."""
    from masr_tpu_torch.decoders.klm_probing import write_probing
    from masr_tpu_torch.decoders.scorer import KenlmScorer, is_kenlm_binary
    arpa = tmp_path / "lm.arpa"
    arpa.write_text(ARPA_ZH, encoding="utf-8")
    klm = tmp_path / "lm.klm"
    write_probing(str(arpa), str(klm))
    assert is_kenlm_binary(str(klm)) and not is_kenlm_binary(str(arpa))
    vocab = ["<blank>", "你", "好", "天", "气"]
    probs = np.full((5, 5), 0.01, np.float32)
    probs[0, 1], probs[1, 0], probs[2, 2], probs[2, 3] = 0.9, 0.9, 0.42, 0.5
    probs[3, 0] = probs[4, 0] = 0.9
    probs /= probs.sum(axis=1, keepdims=True)
    port, ref = _pair(vocab=vocab, alpha=2.2, beta=0.0, beam_size=8,
                      cutoff_top_n=5, language_model_path=str(klm))
    assert isinstance(port.scorer, KenlmScorer) and port.engine == "python"
    got = port.decode_beam_search_offline(probs)
    _same(got, ref.decode_beam_search_offline(probs))
    arpa_dec, _ = _pair(vocab=vocab, alpha=2.2, beta=0.0, beam_size=8,
                        cutoff_top_n=5, language_model_path=str(arpa),
                        use_native=False)
    want = arpa_dec.decode_beam_search_offline(probs)
    assert got[1] == want[1] == "你好"
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)


def test_kenlm_scorer_threads_kenlm_state(tmp_path, monkeypatch):
    """With a `kenlm` module importable, KenlmScorer threads its state as
    masr_tpu's does (a stand-in module scoring with the ARPA scorer)."""
    from masr_tpu_torch.decoders.scorer import (KENLM_MAGIC, ArpaLM,
                                                KenlmScorer, Scorer)
    arpa = tmp_path / "lm.arpa"
    arpa.write_text(ARPA_ZH, encoding="utf-8")
    lm = ArpaLM(str(arpa))

    class State:
        def __init__(self):
            self.ctx = ()

    class Model:
        order = lm.order

        def __init__(self, path):
            pass

        def NullContextWrite(self, st):
            st.ctx = ()

        def BaseScore(self, st, word, out):
            out.ctx = (st.ctx + (word,))[-(self.order - 1):]
            return lm.log10_cond(list(st.ctx), word)

        def __contains__(self, w):
            return (w,) in lm.ngrams

    mod = types.ModuleType("kenlm")
    mod.Model, mod.State = Model, State
    monkeypatch.setitem(sys.modules, "kenlm", mod)
    klm = tmp_path / "lm.klm"
    klm.write_bytes(KENLM_MAGIC + b"\x00" * 64)
    ks, ss = KenlmScorer(2.2, 4.3, str(klm)), Scorer(2.2, 4.3, str(arpa))
    for ctx, w in [([], "你"), (["你"], "好"), (["你", "好"], "你"),
                   (["天"], "好")]:
        np.testing.assert_allclose(ks.score_word(ctx, w),
                                   ss.score_word(ctx, w), rtol=1e-6)


def test_unreadable_klm_decodes_without_lm(tmp_path, monkeypatch):
    from masr_tpu_torch.decoders.scorer import KENLM_MAGIC
    monkeypatch.setitem(sys.modules, "kenlm", None)
    klm = tmp_path / "bad.klm"
    klm.write_bytes(KENLM_MAGIC + b" 5\n\x00" + b"\x00" * 64)
    port, _ = _pair(beam_size=8, language_model_path=str(klm))
    assert port.scorer is None and port._native_scorer is None
    assert isinstance(port.decode_beam_search_offline(
        _rand_probs(5, 0))[1], str)
