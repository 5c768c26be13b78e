"""The port's streaming entry points against masr_tpu's, on the CPU.

- MASRPredictor.predict_stream, with the fused sample-domain frontend and
  the host frontend, fed whole and in 0.2 s pieces, on a tiny bundle that
  masr_tpu exports (D=64, 2 heads, FFN 96, conv 7, 2 blocks) and on the
  trained example bundle: texts equal to masr_tpu's, fed the same way.
- BatchStreamSession (ctc_greedy) against masr_tpu's unforced (vmapped)
  engine: interleaved streams with staggered starts, feed_many; slot
  reuse; tick_chunks=2 equal to 1; slots that cross the position-table
  horizon and take the exact-positions step. Texts must be equal.
Every encoder layer runs through fused_chunk_layer, which takes its plain
PyTorch version on CPU tensors; the CUDA kernel is held against that in
tests/test_torch_cuda_kernels.py.
"""
import os

import numpy as np
import pytest
from test_torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
EXAMPLE = os.path.join(REPO, "examples", "tiny_zh_synth", "inference_model")
# held-out sentences of the example bundle's corpus and their speakers
# (tests/test_example_bundle.py)
HELD_OUT = [("上家音月火少", 0), ("风大你火下雪", 1), ("蓝右黑真", 0)]
PIECE = 3200                                          # 0.2 s at 16 kHz


@pytest.fixture(scope="module")
def tiny_bundle(tmp_path_factory):
    """A streaming conformer exported by masr_tpu with weights from a
    seed."""
    import jax
    import jax.numpy as jnp
    from masr_tpu.infer.bundle import save_inference_bundle
    from masr_tpu.models.cmvn import GlobalCMVN
    from masr_tpu.models.registry import build_model

    feat = 80
    vocab = ["<blank>", "<unk>", "你", "好", "天", "<space>", "<eos>"]
    enc = dict(output_size=64, attention_heads=2, linear_units=96,
               num_blocks=2, cnn_module_kernel=7)
    dec = dict(attention_heads=2, linear_units=32, num_blocks=1,
               r_num_blocks=0)
    mean, istd = np.full(feat, 8.0), np.full(feat, 0.25)
    model = build_model("conformer", feat, len(vocab), streaming=True,
                        encoder_conf=enc, decoder_conf=dec,
                        model_conf=dict(ctc_weight=0.5),
                        cmvn=GlobalCMVN(mean, istd))
    rng = jax.random.PRNGKey(3)
    variables = jax.jit(model.init, static_argnames=("train",))(
        {"params": rng, "dropout": rng, "chunk": rng},
        jnp.zeros((1, 67, feat)), jnp.asarray([67]),
        jnp.zeros((1, 4), jnp.int32), jnp.asarray([4]), train=False)
    # perturbed weights and a CTC head x8: frames peak on varied tokens,
    # as a trained model's do, instead of one token everywhere
    rs = np.random.RandomState(3)
    variables = jax.tree_util.tree_map_with_path(
        lambda path, l: (np.asarray(l) + 0.1 * rs.standard_normal(l.shape))
        .astype(np.float32) * (8.0 if "ctc_lo" in jax.tree_util.keystr(path)
                               else 1.0), variables)
    out = str(tmp_path_factory.mktemp("stream_bundle"))
    save_inference_bundle(out, "conformer", True, feat, vocab, mean, istd,
                          enc, dec, dict(ctc_weight=0.5),
                          {"feature_method": "fbank", "n_mels": feat},
                          variables)
    return out


def _wave(seed, n_chars):
    """Speech-like audio: n_chars random characters of the example corpus
    through the synthetic voice (about 0.2 s each) over a noise floor."""
    rs = np.random.RandomState(seed)
    text = "".join(rs.choice(list("上家音月火少风大你下雪蓝右黑真"), n_chars))
    wav = _render(text, seed % 4)
    # a noise floor: no piece is digital silence, which dB normalization
    # refuses
    return wav + 1e-3 * rs.standard_normal(len(wav)).astype(np.float32)


def _render(text, spk):
    from masr_tpu_torch.audio.synth_tts import SyntheticTTS
    return SyntheticTTS(sample_rate=16000).render(text, spk_id=spk)


def _stream(predictor, wav, piece=None):
    """predict_stream over the whole utterance, or over pieces of `piece`
    samples → the final text."""
    piece = piece or len(wav)
    out = None
    for i in range(0, len(wav), piece):
        r = predictor.predict_stream(wav[i:i + piece],
                                     is_end=i + piece >= len(wav),
                                     sample_rate=16000)
        out = r if r is not None else out
    predictor.reset_stream()
    return out["text"]


def _predictors(model_dir, fused):
    from masr_tpu.infer.predictor import MASRPredictor as JaxPredictor
    from masr_tpu_torch.infer.predictor import MASRPredictor
    return (MASRPredictor(model_dir=model_dir, device="cpu", warmup=False,
                          fused_frontend=fused),
            JaxPredictor(model_dir=model_dir, warmup=False,
                         fused_frontend=fused))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "host"])
def test_predict_stream_matches_masr_tpu_tiny_bundle(tiny_bundle, fused):
    """Whole and in 0.2 s pieces: the port's text equals masr_tpu's for
    the same feeding. (The two feedings may differ: dB normalization takes
    its gain over each call's buffer.)"""
    port, ref = _predictors(tiny_bundle, fused)
    assert port.fused_frontend == fused
    texts = []
    for seed, n_chars in ((0, 11), (1, 4)):
        wav = _wave(seed, n_chars)
        for piece in (None, PIECE):
            got, want = _stream(port, wav, piece), _stream(ref, wav, piece)
            assert got == want, (seed, piece)
            texts.append(got)
    assert texts[0] != texts[2] and all(texts)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "host"])
def test_predict_stream_matches_masr_tpu_example_bundle(fused):
    """The trained bundle's held-out sentences, whole and in 0.2 s
    pieces: same text as masr_tpu, and it recognises >= 2 of the 3."""
    port, ref = _predictors(EXAMPLE, fused)
    hits = 0
    for text, spk in HELD_OUT:
        wav = _render(text, spk)
        whole = _stream(port, wav)
        assert whole == _stream(ref, wav), text
        assert _stream(port, wav, PIECE) == _stream(ref, wav, PIECE), text
        hits += whole == text
    assert hits >= 2


# --------------------------------------------------------------------------- #
# BatchStreamSession
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def engines(tiny_bundle):
    """(port predictor, masr_tpu predictor) on the tiny bundle, host
    frontend (the engine's)."""
    return _predictors(tiny_bundle, fused=False)


def _port_session(port, **kw):
    from masr_tpu_torch.infer.batch_stream import BatchStreamSession
    return BatchStreamSession(
        port.predictor, port._vocab_list,
        preprocess_conf=port.predictor.meta["preprocess_conf"], **kw)


def _jax_session(ref, **kw):
    from masr_tpu.infer.batch_stream import BatchStreamSession
    sess = BatchStreamSession(
        ref.predictor, ref._text_featurizer.vocab_list,
        preprocess_conf=ref.predictor.meta["preprocess_conf"], **kw)
    assert not sess._use_fused_chunk         # the vmapped XLA engine
    return sess


def _interleaved(sess, waves, step, many=False):
    """Stream k starts k pieces late; pieces of `step` samples go in
    through feed (one slot at a time) or feed_many (all ready slots in
    one call) → the final text of every stream."""
    slots = [sess.open() for _ in waves]
    texts = [None] * len(waves)
    n = max(len(w) for w in waves) // step + 1 + len(waves)
    for i in range(n):
        items = []
        for k, slot in enumerate(slots):
            piece = waves[k][max(i - k, 0) * step:(i - k + 1) * step]
            if i >= k and len(piece):
                items.append((slot, piece,
                              (i - k + 1) * step >= len(waves[k])))
        if many and items:
            outs = sess.feed_many(items)
        else:
            outs = {slot: sess.feed(slot, piece, is_end=end)
                    for slot, piece, end in items}
        for k, slot in enumerate(slots):
            if outs.get(slot) is not None:
                texts[k] = outs[slot]["text"]
    for slot in slots:
        sess.close(slot)
    return texts


@pytest.mark.parametrize("many", [False, True], ids=["feed", "feed_many"])
def test_engine_matches_masr_tpu_engine(engines, many):
    """Three staggered streams of different lengths in 0.25 s pieces: the
    port's engine gives masr_tpu's engine's texts, and each equals the
    port's own single-stream predict_stream text."""
    port, ref = engines
    waves = [_wave(20 + s, 5 + 3 * s) for s in range(3)]
    got = _interleaved(_port_session(port, max_streams=4), waves, 4000, many)
    want = _interleaved(_jax_session(ref, max_streams=4), waves, 4000, many)
    assert got == want
    assert got == [_stream(port, w) for w in waves]
    assert len(set(got)) == len(got)          # three different texts


def test_engine_slot_reuse_and_isolation(engines):
    """A closed slot reopens fresh: the same audio gives the same text,
    while another stream runs beside it."""
    port, _ = engines
    sess = _port_session(port, max_streams=2)
    w, other = _wave(1, 7), _wave(2, 10)
    s1 = sess.open()
    r1 = sess.feed(s1, w, is_end=True)
    sess.close(s1)
    s_other = sess.open()
    sess.feed(s_other, other[:16000])
    s2 = sess.open()
    assert s2 != s_other
    r2 = sess.feed(s2, w, is_end=True)
    sess.feed(s_other, other[16000:], is_end=True)
    assert r1["text"] == r2["text"] == _stream(port, w)


def test_engine_multi_chunk_ticks_match_single(engines):
    """tick_chunks=2 runs two buffered windows per slot in one step
    (block-causal): the texts equal tick_chunks=1, and masr_tpu's."""
    port, ref = engines
    waves = [_wave(30 + s, 13 - 2 * s) for s in range(2)]
    multi = _port_session(port, max_streams=2, tick_chunks=2)
    assert multi.tick_k == 2
    ticks = []
    orig = multi._dispatch

    def spy(xs, active, valids, exact):
        ticks.append(xs.shape[1])
        return orig(xs, active, valids, exact)

    multi._dispatch = spy
    got = _interleaved(multi, waves, 24000)
    assert 2 in ticks
    single = _interleaved(_port_session(port, max_streams=2), waves, 24000)
    assert got == single
    assert got == _interleaved(_jax_session(ref, max_streams=2), waves,
                               24000)


def test_engine_crosses_position_horizon(engines):
    """With a position table barely longer than one window, slots pass
    its horizon and switch to the exact-positions step, alone or beside a
    slot still on the table: texts are unchanged."""
    port, ref = engines
    waves = [_wave(40, 15), _wave(41, 7)]
    small = _port_session(port, max_streams=2,
                          pos_table_len=port.predictor.cache_size + 48)
    routes = []
    orig = small._dispatch

    def spy(xs, active, valids, exact):
        routes.append((int(np.asarray(active).sum()), bool(exact)))
        return orig(xs, active, valids, exact)

    small._dispatch = spy
    got = _interleaved(small, waves, 8000, many=True)
    assert any(exact for _, exact in routes)
    assert any(not exact for _, exact in routes)
    big = _port_session(port, max_streams=2, pos_table_len=8192)
    assert got == _interleaved(big, waves, 8000, many=True)
    assert got == _interleaved(_jax_session(ref, max_streams=2), waves,
                               8000, many=True)
