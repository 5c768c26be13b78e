"""The port's batched device beam (masr_tpu_torch/decoders/device_beam.py)
on the CPU against masr_tpu's (ctc_beam_search_jax, decode_batch_device,
DeviceBeamStream, make_stream_decode_fn) under JAX on the CPU: same
texts, same best beams' tokens, scores within 1e-4; the rolling hashes
bit-equal; ties broken to the lower index, as lax.top_k does; dense-bigram
fusion, its table equal to masr_tpu's. The cases of
tests/test_device_beam.py, on the port. The card runs the same code
(tests/test_torch_cuda_kernels.py holds it against this CPU run).
"""
import numpy as np
import pytest
import torch
from test_torch_threads import one_torch_thread  # noqa: F401

V = 12
VOCAB = ["<blank>"] + [chr(ord("a") + i) for i in range(V - 1)]
SCORE_ATOL = 1e-4

ARPA = """\\data\\
ngram 1=6
ngram 2=4

\\1-grams:
-0.4\ta\t-0.3
-0.5\tb\t-0.3
-2.2\tc\t-0.3
-1.0\td\t-0.3
-3.0\t<unk>
-0.4\t<s>\t-0.3

\\2-grams:
-0.05\ta b
-2.6\ta c
-0.4\tb a
-0.5\tb d

\\end\\
"""


def _lattice(T, seed, peaky=False, V=V):
    rs = np.random.RandomState(seed)
    logits = rs.standard_normal((T, V)).astype(np.float32)
    if peaky:
        logits[np.arange(T), rs.randint(0, V, T)] += 4.0
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


@pytest.fixture()
def lm(tmp_path):
    from masr_tpu.decoders.device_beam import build_dense_bigram as ref
    from masr_tpu_torch.decoders.device_beam import build_dense_bigram
    p = tmp_path / "lm.arpa"
    p.write_text(ARPA, encoding="utf-8")
    table = build_dense_bigram(str(p), VOCAB)
    return str(p), table, ref(str(p), VOCAB, cache=False)


def _both(probs, lens, **kw):
    """(port's, masr_tpu's) ctc_beam_search output as numpy."""
    import jax.numpy as jnp
    from masr_tpu.decoders.device_beam import ctc_beam_search_jax
    from masr_tpu_torch.decoders.device_beam import ctc_beam_search
    got = ctc_beam_search(torch.from_numpy(probs), lens, **kw)
    jkw = dict(kw)
    if jkw.get("lm_table") is not None:
        jkw["lm_table"] = jnp.asarray(jkw["lm_table"])
    want = ctc_beam_search_jax(jnp.asarray(probs), jnp.asarray(lens),
                               **jkw)
    return ([t.numpy() for t in got], [np.asarray(t) for t in want])


@pytest.mark.parametrize("seed,peaky", [(0, False), (1, False), (2, True),
                                        (3, True), (4, False)])
def test_beams_equal_masr_tpu(seed, peaky):
    """Every beam's tokens and length equal, scores within 1e-4, at B=3
    with ragged lengths."""
    probs = np.stack([_lattice(25, seed + 10 * b, peaky) for b in range(3)])
    lens = np.asarray([25, 17, 4])
    (tok, ln, sc), (jtok, jln, jsc) = _both(probs, lens, beam_size=8,
                                            cutoff_top_n=6)
    live = jsc > -1e8
    np.testing.assert_array_equal(ln[live], jln[live])
    for b, w in zip(*np.nonzero(live)):
        assert list(tok[b, w, :ln[b, w]]) == list(jtok[b, w, :jln[b, w]])
    np.testing.assert_allclose(sc[live], jsc[live], rtol=0, atol=SCORE_ATOL)


@pytest.mark.parametrize("seed", [0, 3, 5])
def test_decode_batch_device_equals_masr_tpu(seed):
    from masr_tpu.decoders.device_beam import decode_batch_device as ref
    from masr_tpu_torch.decoders.device_beam import decode_batch_device
    probs = np.stack([_lattice(20, seed + b, b % 2 == 0) for b in range(4)])
    lens = np.asarray([20, 20, 13, 20])
    got = decode_batch_device(probs, lens, VOCAB, beam_size=8,
                              cutoff_top_n=6)
    want = ref(probs, lens, VOCAB, beam_size=8, cutoff_top_n=6)
    for (s, t), (rs_, rt) in zip(got, want):
        assert t == rt
        assert abs(s - rs_) <= SCORE_ATOL


def test_matches_python_engine():
    """The host Python engine at cutoff_prob 1.0 gives the same best."""
    from masr_tpu_torch.decoders.beam_search import _PyPrefixBeamSearch
    from masr_tpu_torch.decoders.device_beam import decode_batch_device
    for seed in range(3):
        probs = _lattice(25, seed, seed == 2)
        eng = _PyPrefixBeamSearch(VOCAB, beam_size=8, cutoff_prob=1.0,
                                  cutoff_top_n=6, blank_id=0)
        eng.step(probs)
        score, text = eng.result()
        got = decode_batch_device(probs[None], np.asarray([25]), VOCAB,
                                  beam_size=8, cutoff_top_n=6)[0]
        assert got[1] == text
        np.testing.assert_allclose(got[0], score, rtol=1e-4, atol=1e-4)


def test_rolling_hashes_bit_equal():
    """extend_hash in int64 reduced mod 2^32 == masr_tpu's uint32
    h·mult + tok + 2, at the extremes and on random values."""
    import jax
    import jax.numpy as jnp
    from masr_tpu.decoders import device_beam as J
    from masr_tpu_torch.decoders.device_beam import (_MULT1, _MULT2,
                                                     extend_hash)
    rs = np.random.RandomState(0)
    h = np.concatenate([np.asarray([0, 1, 2 ** 31, 2 ** 32 - 1,
                                    2 ** 32 - 2], np.uint64),
                        rs.randint(0, 2 ** 32, 4000, dtype=np.uint64)])
    tok = rs.randint(0, 5000, len(h)).astype(np.int32)
    tok[:5] = [0, 4999, 1, 4999, 3]
    for mult, jmult in ((_MULT1, J._MULT1), (_MULT2, J._MULT2)):
        got = extend_hash(torch.from_numpy(h.astype(np.int64)),
                          torch.from_numpy(tok), mult).numpy()
        want = np.asarray(jnp.asarray(h.astype(np.uint32)) * jmult
                          + jnp.asarray(tok).astype(jnp.uint32) + 2)
        np.testing.assert_array_equal(got, want.astype(np.int64))
    # the state's hashes after a search equal masr_tpu's
    from masr_tpu_torch.decoders.device_beam import _scan, init_state
    probs = _lattice(12, 4, True)
    st = _scan(init_state(1, 6, 12), torch.log(torch.from_numpy(probs))[None],
               torch.ones(1, 12, dtype=torch.bool), 6, 5, 0, None, 0.0, 0.0,
               -1)
    jst = J.init_state(1, 6, 12)
    lp = jnp.log(jnp.asarray(probs))
    # one compiled step (op by op, each frame dispatches every op anew)
    step = jax.jit(J.beam_step, static_argnums=(3, 4, 5))
    for t in range(12):
        jst = step(jst, lp[t][None], jnp.asarray([True]), 6, 5, 0)
    for k in ("h1", "h2"):
        np.testing.assert_array_equal(st[k].numpy(),
                                      np.asarray(jst[k]).astype(np.int64))


def test_ties_go_to_the_lower_index():
    """Equal probabilities everywhere: every top-k tie resolves as
    lax.top_k resolves it, so the beams and their order equal
    masr_tpu's."""
    probs = np.full((1, 6, V), 1.0 / V, np.float32)
    (tok, ln, sc), (jtok, jln, jsc) = _both(probs, np.asarray([6]),
                                            beam_size=5, cutoff_top_n=4)
    np.testing.assert_array_equal(tok, jtok)
    np.testing.assert_array_equal(ln, jln)
    np.testing.assert_allclose(sc, jsc, atol=SCORE_ATOL)
    from masr_tpu_torch.decoders.device_beam import _top
    v, i = _top(torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]]), 3)
    assert i.tolist() == [[1, 2, 4]]


def test_padded_frames_do_not_count():
    from masr_tpu_torch.decoders.device_beam import decode_batch_device
    probs = _lattice(15, 7, peaky=True)
    padded = np.concatenate([probs, _lattice(10, 8)], axis=0)
    a = decode_batch_device(padded[None], np.asarray([15]), VOCAB,
                            beam_size=8, cutoff_top_n=6)[0]
    b = decode_batch_device(probs[None], np.asarray([15]), VOCAB,
                            beam_size=8, cutoff_top_n=6)[0]
    assert a[1] == b[1]
    np.testing.assert_allclose(a[0], b[0], rtol=1e-5)


def test_batched_equals_per_utterance():
    from masr_tpu_torch.decoders.device_beam import decode_batch_device
    probs = np.stack([_lattice(20, s, s % 2 == 0) for s in range(6)])
    lens = np.full(6, 20)
    batched = decode_batch_device(probs, lens, VOCAB, beam_size=8,
                                  cutoff_top_n=6)
    for b in range(6):
        single = decode_batch_device(probs[b:b + 1], lens[b:b + 1], VOCAB,
                                     beam_size=8, cutoff_top_n=6)[0]
        assert batched[b][1] == single[1]
        np.testing.assert_allclose(batched[b][0], single[0], rtol=1e-4)


def test_nbest_sorted_and_distinct():
    from masr_tpu_torch.decoders.device_beam import ctc_beam_search
    tok, ln, sc = (t.numpy()[0] for t in ctc_beam_search(
        torch.from_numpy(_lattice(25, 11)[None]), [25], beam_size=8,
        cutoff_top_n=6))
    assert (np.diff(sc) <= 1e-6).all()
    keys = [tuple(tok[w, :ln[w]]) for w in range(8) if sc[w] > -1e8]
    assert len(keys) == len(set(keys))


def test_clear_sequence():
    from masr_tpu_torch.decoders.device_beam import decode_batch_device
    seq = [1, 1, 0, 2, 0, 3, 3, 0, 4]
    probs = np.full((len(seq), V), 0.001, np.float32)
    probs[np.arange(len(seq)), seq] = 0.99
    probs /= probs.sum(axis=1, keepdims=True)
    assert decode_batch_device(probs[None], [len(seq)], VOCAB, beam_size=4,
                               cutoff_top_n=4)[0][1] == "abcd"


# --------------------------------------------------------------------- #
# streaming
# --------------------------------------------------------------------- #
def test_stream_equals_masr_tpu_and_offline():
    """DeviceBeamStream over ragged chunks (a padded last one): the
    offline best and masr_tpu's DeviceBeamStream."""
    from masr_tpu.decoders.device_beam import DeviceBeamStream as Ref
    from masr_tpu_torch.decoders.device_beam import (DeviceBeamStream,
                                                     ctc_beam_search)
    probs = _lattice(23, 13, peaky=True)
    tok, ln, sc = ctc_beam_search(torch.from_numpy(probs[None]), [23],
                                  beam_size=8, cutoff_top_n=6)
    port = DeviceBeamStream(batch=1, beam_size=8, cutoff_top_n=6,
                            max_len=32, device="cpu")
    ref = Ref(batch=1, beam_size=8, cutoff_top_n=6, max_len=32)
    for i in range(0, 23, 5):
        chunk = probs[i:i + 5]
        valid = np.ones((1, chunk.shape[0]), bool)
        if chunk.shape[0] < 5:
            pad = 5 - chunk.shape[0]
            chunk = np.pad(chunk, ((0, pad), (0, 0)))
            valid = np.pad(valid, ((0, 0), (0, pad)))
        port.feed(chunk[None], valid)
        ref.feed(chunk[None], valid)
    ids, score = port.best(0)
    assert ids == tok[0, 0, :int(ln[0, 0])].tolist()
    np.testing.assert_allclose(score, float(sc[0, 0]), rtol=1e-5)
    r_ids, r_score = ref.best(0)
    assert ids == [int(i) for i in r_ids]
    assert abs(score - r_score) <= SCORE_ATOL


def test_stream_slot_isolation_and_reset():
    from masr_tpu_torch.decoders.device_beam import (DeviceBeamStream,
                                                     decode_batch_device)
    la, lb = _lattice(20, 21, True), _lattice(20, 22, True)
    stream = DeviceBeamStream(batch=3, beam_size=8, cutoff_top_n=6,
                              max_len=32, device="cpu")
    for i in range(0, 20, 4):
        fv = np.zeros((3, 4), bool)
        chunk = np.zeros((3, 4, V), np.float32)
        chunk[0], fv[0] = la[i:i + 4], True
        stream.feed(chunk, fv)
        if i % 8 == 0:
            part = lb[i:i + 8]
            c2 = np.zeros((3, 8, V), np.float32)
            fv2 = np.zeros((3, 8), bool)
            c2[2, :len(part)], fv2[2, :len(part)] = part, True
            stream.feed(c2, fv2)

    def text(ids):
        return "".join(VOCAB[i] for i in ids)

    ra = decode_batch_device(la[None], [20], VOCAB, beam_size=8,
                             cutoff_top_n=6)[0]
    rb = decode_batch_device(lb[None], [20], VOCAB, beam_size=8,
                             cutoff_top_n=6)[0]
    assert text(stream.best(0)[0]) == ra[1]
    assert text(stream.best(2)[0]) == rb[1]
    assert stream.best(1)[0] == []
    stream.reset_slots([0])
    assert stream.best(0)[0] == []
    assert text(stream.best(2)[0]) == rb[1]


def test_stream_device_is_the_card_unless_asked():
    """DeviceBeamStream lives on the card by default (it raises where
    there is none) and refuses probs from another device instead of
    copying them to its own."""
    from masr_tpu_torch.decoders.device_beam import DeviceBeamStream
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            DeviceBeamStream(batch=1)
    stream = DeviceBeamStream(batch=1, device="cpu")
    assert all(v.device.type == "cpu" for v in stream.state.values())
    with pytest.raises(ValueError, match="probs on meta"):
        stream.feed(torch.empty((1, 4, V), device="meta"))


@pytest.mark.parametrize("max_run", [1, 2, 5])
def test_segment_logsumexp_equals_masr_tpu(max_run):
    """The segment reduce by run id against masr_tpu's doubling passes on
    sorted hashes with runs of up to max_run equal entries (a beam step
    makes runs of at most 2): the same run starts, the same merged values
    (bit for bit up to runs of 2, within 1e-6 beyond)."""
    import jax.numpy as jnp
    from masr_tpu.decoders.device_beam import _segment_logsumexp as ref
    from masr_tpu_torch.decoders.device_beam import NEG, _segment_logsumexp
    rs = np.random.RandomState(max_run)
    B, C = 3, 90
    runs = rs.randint(1, max_run + 1, size=(B, C)).cumsum(axis=1)
    h1 = np.stack([np.repeat(np.arange(C), np.diff(np.r_[0, r]))[:C]
                   for r in np.minimum(runs, C)])
    h2 = (h1 * 7) % 5
    vals = rs.uniform(-30, 0, size=(B, C, 2)).astype(np.float32)
    vals[0, ::7, 1] = NEG
    merged, start = _segment_logsumexp(torch.from_numpy(h1),
                                       torch.from_numpy(h2),
                                       torch.from_numpy(vals))
    for k in range(2):
        want, want_start = ref(jnp.asarray(h1), jnp.asarray(h2),
                               jnp.asarray(vals[:, :, k]))
        np.testing.assert_array_equal(start.numpy(), np.asarray(want_start))
        got, want = merged[:, :, k].numpy(), np.asarray(want)
        if max_run <= 2:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_stream_decode_fn_equals_masr_tpu(lm):
    """make_stream_decode_fn with LM fusion, chunk by chunk: the best beam
    per slot equals masr_tpu's after every chunk."""
    import jax.numpy as jnp
    from masr_tpu.decoders.device_beam import make_stream_decode_fn as ref
    from masr_tpu_torch.decoders.device_beam import make_stream_decode_fn
    _, table, _ = lm
    kw = dict(beam_size=6, cutoff_top_n=5, lm_table=table, alpha=2.0,
              beta=0.5, space_id=-1, max_len=40)
    init, dec = make_stream_decode_fn(**kw)
    jinit, jdec = ref(**kw)
    st, jst = init(2), jinit(2)
    probs = np.stack([_lattice(24, 31, True), _lattice(24, 32, True)])
    for i in range(0, 24, 8):
        fv = np.ones((2, 8), bool)
        fv[1, 5:] = i < 16
        st, (tok, ln, sc) = dec(st, torch.from_numpy(probs[:, i:i + 8]), fv)
        jst, (jtok, jln, jsc) = jdec(jst, jnp.asarray(probs[:, i:i + 8]),
                                     jnp.asarray(fv))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        np.testing.assert_array_equal(ln.numpy(), np.asarray(jln))
        np.testing.assert_allclose(sc.numpy(), np.asarray(jsc),
                                   atol=SCORE_ATOL)


# --------------------------------------------------------------------- #
# dense-bigram LM fusion
# --------------------------------------------------------------------- #
def test_dense_bigram_equals_masr_tpu(lm, tmp_path):
    """The table equals masr_tpu's build_dense_bigram bit for bit, on the
    small LM and on a vocabulary with <space>, <unk> and characters the
    LM lacks."""
    from masr_tpu.decoders.device_beam import build_dense_bigram as ref
    from masr_tpu_torch.decoders.device_beam import build_dense_bigram
    path, table, want = lm
    assert table.dtype == np.float32 and table.shape == (V + 1, V)
    np.testing.assert_array_equal(table, want)
    vocab = ["<blank>", "<unk>", "a", "b", "<space>", "z", "c", "d",
             "<eos>"]
    np.testing.assert_array_equal(build_dense_bigram(path, vocab),
                                  ref(path, vocab, cache=False))
    uni = tmp_path / "uni.arpa"
    uni.write_text("\\data\\\nngram 1=3\n\n\\1-grams:\n-0.4\ta\n-0.5\tb\n"
                   "-1.0\t<unk>\n\n\\end\\\n")
    np.testing.assert_array_equal(build_dense_bigram(str(uni), vocab),
                                  ref(str(uni), vocab, cache=False))


@pytest.mark.parametrize("seed", [0, 3, 5])
def test_lm_fusion_equals_masr_tpu_and_python_engine(lm, seed):
    from masr_tpu_torch.decoders.beam_search import _PyPrefixBeamSearch
    from masr_tpu_torch.decoders.device_beam import decode_batch_device
    from masr_tpu_torch.decoders.scorer import Scorer
    path, table, _ = lm
    probs = _lattice(18, seed, peaky=True)
    (tok, ln, sc), (jtok, jln, jsc) = _both(
        probs[None], np.asarray([18]), beam_size=8, cutoff_top_n=6,
        lm_table=table, alpha=2.0, beta=0.5)
    assert list(tok[0, 0, :ln[0, 0]]) == list(jtok[0, 0, :jln[0, 0]])
    np.testing.assert_allclose(sc[0, 0], jsc[0, 0], atol=SCORE_ATOL)
    eng = _PyPrefixBeamSearch(VOCAB, beam_size=8, cutoff_prob=1.0,
                              cutoff_top_n=6, blank_id=0,
                              scorer=Scorer(2.0, 0.5, path))
    eng.step(probs)
    score_py, text_py = eng.result()
    got = decode_batch_device(probs[None], [18], VOCAB, beam_size=8,
                              cutoff_top_n=6, lm_table=table, alpha=2.0,
                              beta=0.5)[0]
    assert got[1] == text_py
    np.testing.assert_allclose(got[0], score_py, rtol=1e-4, atol=1e-4)


def test_lm_fusion_flips_ambiguous(lm):
    from masr_tpu_torch.decoders.device_beam import decode_batch_device
    _, table, _ = lm
    probs = np.full((5, V), 1e-6, np.float32)
    probs[0, 1], probs[1, 0], probs[2, 2], probs[2, 3] = 0.9, 0.9, 0.4, 0.5
    probs[3, 0] = probs[4, 0] = 0.9
    probs /= probs.sum(axis=1, keepdims=True)
    kw = dict(beam_size=8, cutoff_top_n=6)
    assert decode_batch_device(probs[None], [5], VOCAB, **kw)[0][1] == "ac"
    assert decode_batch_device(probs[None], [5], VOCAB, lm_table=table,
                               alpha=2.0, beta=0.0, **kw)[0][1] == "ab"


def test_lm_stream_equals_offline(lm):
    from masr_tpu_torch.decoders.device_beam import (DeviceBeamStream,
                                                     decode_batch_device)
    _, table, _ = lm
    probs = _lattice(20, 9, peaky=True)
    offline = decode_batch_device(probs[None], [20], VOCAB, beam_size=8,
                                  cutoff_top_n=6, lm_table=table,
                                  alpha=2.0, beta=0.5)[0]
    stream = DeviceBeamStream(batch=1, beam_size=8, cutoff_top_n=6,
                              max_len=32, lm_table=table, alpha=2.0,
                              beta=0.5, device="cpu")
    for i in range(0, 20, 4):
        stream.feed(probs[None, i:i + 4])
    ids, score = stream.best(0)
    assert "".join(VOCAB[i] for i in ids) == offline[1]
    np.testing.assert_allclose(score, offline[0], rtol=1e-5)


def test_alpha_zero_equals_no_lm(lm):
    from masr_tpu_torch.decoders.device_beam import decode_batch_device
    _, table, _ = lm
    probs = _lattice(15, 17, peaky=True)
    base = decode_batch_device(probs[None], [15], VOCAB, beam_size=8,
                               cutoff_top_n=6)[0]
    zero = decode_batch_device(probs[None], [15], VOCAB, beam_size=8,
                               cutoff_top_n=6, lm_table=table, alpha=0.0,
                               beta=0.0)[0]
    assert zero[1] == base[1]
    np.testing.assert_allclose(zero[0], base[0], rtol=1e-5)
