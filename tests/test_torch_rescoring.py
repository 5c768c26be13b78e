"""Attention rescoring and the decoders beyond greedy through the port's
entry points, against masr_tpu on the CPU.

- rescore_hyps (models/conformer.py, inherited by the Squeezeformer)
  against flax's on carried weights, within 1e-4, reverse_weight 0 and
  0.3, both families, with and without masr_tpu's padding of the n-best
  (nbest_pad rows of a length rounded up to 8); encode_for_rescoring's
  rows and lengths against flax's (the Squeezeformer's time reduction
  leaves its length as masr_tpu's); InferencePredictor.rescore against
  masr_tpu's.
- MASRPredictor with ctc_beam_search (with and without an ARPA LM),
  attention_rescoring and ctc_beam_search_device on the trained example
  bundle: predict, predict_batch and predict_stream (two-pass for
  attention_rescoring) give masr_tpu's texts; BatchStreamSession with
  ctc_beam_search_device gives masr_tpu's engine's texts and the port's
  own predict_stream texts.
(MASRTrainer's eval with each decoder: tests/test_torch_eval_decoders.py.)
"""
import os

import numpy as np
import pytest
import torch
from test_torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
EXAMPLE = os.path.join(REPO, "examples", "tiny_zh_synth", "inference_model")
HELD_OUT = [("上家音月火少", 0), ("风大你火下雪", 1), ("蓝右黑真", 0)]
PIECE = 3200
FEAT = 80
VOCAB = ["<blank>", "<unk>"] + list("你好天气真完我家业世界") + ["<eos>"]
FAMILIES = {
    "conformer": dict(output_size=64, attention_heads=2, linear_units=96,
                      num_blocks=2, cnn_module_kernel=7),
    "squeezeformer": dict(encoder_dim=64, output_size=64, attention_heads=2,
                          num_blocks=3, reduce_idx=1, recover_idx=2,
                          feed_forward_expansion_factor=2,
                          cnn_module_kernel=7),
}
DEC = dict(attention_heads=2, linear_units=48, num_blocks=2, r_num_blocks=1)
SCORE_ATOL = 1e-4


def _perturb(variables, seed, scale=0.1):
    import jax
    rs = np.random.RandomState(seed)
    leaves, treedef = jax.tree.flatten(variables)
    return jax.tree.unflatten(treedef, [
        (np.asarray(l) + rs.standard_normal(l.shape) * scale)
        .astype(np.float32) for l in leaves])


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """{family: bundle dir}: a streaming model of each family with a
    left + right attention decoder (reverse_weight 0.3), exported by
    masr_tpu, weights from a seed, perturbed, the CTC head x8."""
    import jax
    import jax.numpy as jnp
    from masr_tpu.infer.bundle import save_inference_bundle
    from masr_tpu.models.cmvn import GlobalCMVN
    from masr_tpu.models.registry import build_model
    out = {}
    mean, istd = np.full(FEAT, 12.0), np.full(FEAT, 0.3)
    model_conf = dict(ctc_weight=0.3, reverse_weight=0.3)
    for seed, (family, enc) in enumerate(FAMILIES.items()):
        model = build_model(family, FEAT, len(VOCAB), streaming=True,
                            encoder_conf=enc, decoder_conf=DEC,
                            model_conf=model_conf,
                            cmvn=GlobalCMVN(mean, istd))
        rng = jax.random.PRNGKey(seed)
        v = jax.jit(model.init, static_argnames=("train",))(
            {"params": rng, "dropout": rng, "chunk": rng},
            jnp.zeros((1, 67, FEAT)), jnp.asarray([67]),
            jnp.zeros((1, 4), jnp.int32), jnp.asarray([4]), train=False)
        v = _perturb(v, seed)
        v["params"]["ctc"]["ctc_lo"] = {
            k: t * 8.0 for k, t in v["params"]["ctc"]["ctc_lo"].items()}
        path = str(tmp_path_factory.mktemp(family))
        save_inference_bundle(path, family, True, FEAT, VOCAB, mean, istd,
                              enc, DEC, model_conf,
                              {"feature_method": "fbank", "n_mels": FEAT},
                              v)
        out[family] = path
    return out


def _models(path):
    from masr_tpu.infer.bundle import load_inference_bundle as jax_load
    from masr_tpu_torch.infer.bundle import load_inference_bundle
    jmodel, jv, _, _ = jax_load(path)
    port, _, _ = load_inference_bundle(path)
    return jmodel, jv, port


def _hyps(rs, n, lo=1, hi=8):
    return [list(rs.randint(2, len(VOCAB) - 1, rs.randint(lo, hi)))
            for _ in range(n)]


def _pad(hyps, rows, bucket):
    L = -(-max(len(h) for h in hyps) // bucket) * bucket
    out = np.full((rows, L), -1, np.int64)
    lens = np.zeros(rows, np.int64)
    for i, h in enumerate(hyps):
        out[i, :len(h)], lens[i] = h, len(h)
    return out, lens


@pytest.mark.parametrize("padded", [False, True], ids=["exact", "padded"])
@pytest.mark.parametrize("rw", [0.0, 0.3])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_rescore_hyps_equals_flax(bundles, family, rw, padded):
    """The same encoder rows and hypotheses: the port's scores within 1e-4
    of flax's rescore_hyps (fed the hypotheses unpadded); padded to 10 rows
    of a length rounded up to 8, the real rows' scores stay within 1e-4
    of flax's and within 1e-5 of the port's unpadded ones."""
    import jax.numpy as jnp
    jmodel, jv, port = _models(bundles[family])
    rs = np.random.RandomState(3)
    T, n = 23, 6
    enc = rs.standard_normal((1, T, 64)).astype(np.float32)
    hyps = _hyps(rs, n)
    exact, exact_lens = _pad(hyps, n, 1)
    want = np.asarray(jmodel.apply(
        jv, jnp.asarray(enc), jnp.asarray(T - 4), jnp.asarray(exact),
        jnp.asarray(exact_lens), rw, method=type(jmodel).rescore_hyps))
    if padded:
        h, hl = _pad(hyps, 10, 8)
    else:
        h, hl = exact, exact_lens
    got = port.rescore_hyps(torch.from_numpy(enc), T - 4,
                            torch.from_numpy(h), torch.from_numpy(hl),
                            reverse_weight=rw).numpy()
    np.testing.assert_allclose(got[:n], want, rtol=0, atol=SCORE_ATOL)
    if padded:
        unpadded = port.rescore_hyps(
            torch.from_numpy(enc), T - 4, torch.from_numpy(exact),
            torch.from_numpy(exact_lens), reverse_weight=rw).numpy()
        np.testing.assert_allclose(got[:n], unpadded, rtol=0, atol=1e-5)
    if rw == 0.0:
        # the right decoder weighs in only at reverse_weight > 0
        with_r = port.rescore_hyps(torch.from_numpy(enc), T - 4,
                                   torch.from_numpy(h),
                                   torch.from_numpy(hl),
                                   reverse_weight=0.3).numpy()
        assert np.abs(with_r[:n] - got[:n]).max() > 1e-3


@pytest.mark.parametrize("family", list(FAMILIES))
def test_encode_for_rescoring_equals_flax(bundles, family):
    """Encoder rows within 2e-5, CTC probs within 3e-5, lengths equal (the
    Squeezeformer's time reduction and recovery leave T' as masr_tpu's);
    get_encoder_out_chunk_full's rows are the chunk step's output."""
    import jax.numpy as jnp
    jmodel, jv, port = _models(bundles[family])
    rs = np.random.RandomState(6)
    speech = (12.0 + 3.0 * rs.standard_normal((3, 131, FEAT))).astype(
        np.float32)
    lens = np.asarray([131, 99, 57])
    want = jmodel.apply(jv, jnp.asarray(speech), jnp.asarray(lens),
                        method=type(jmodel).encode_for_rescoring)
    with torch.no_grad():
        got = port.encode_for_rescoring(torch.from_numpy(speech),
                                        torch.from_numpy(lens))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2].tolist()[0] == 32 and len(set(got[2].tolist())) == 3
    for b, n in enumerate(got[2].tolist()):
        np.testing.assert_allclose(got[0][b, :n].numpy(),
                                   np.asarray(want[0])[b, :n], atol=2e-5,
                                   rtol=0)
        np.testing.assert_allclose(got[1][b, :n].numpy(),
                                   np.asarray(want[1])[b, :n], atol=3e-5,
                                   rtol=0)
    state = port.encoder.init_cache(batch=1, cache_size=64)
    state2 = port.encoder.init_cache(batch=1, cache_size=64)
    with torch.no_grad():
        probs, hidden = port.get_encoder_out_chunk_full(
            torch.from_numpy(speech[:1, :67]), state)
        rows = port.encoder.forward_chunk(torch.from_numpy(speech[:1, :67]),
                                          state2)
    assert torch.equal(hidden, rows)
    assert torch.equal(probs, port.ctc.softmax(rows))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_inference_rescore_equals_masr_tpu(bundles, family):
    """InferencePredictor.encode_for_rescoring + rescore (padded to
    nbest_pad 10, lengths in buckets of 8): scores within 1e-4 of
    masr_tpu's InferencePredictor and within 1e-5 of the model's
    rescore_hyps on the hypotheses unpadded, the extra hypotheses past
    nbest_pad dropped as masr_tpu drops them."""
    from masr_tpu.infer.inference_model import InferencePredictor as Ref
    from masr_tpu_torch.infer.inference_model import InferencePredictor
    port = InferencePredictor(bundles[family], device="cpu")
    ref = Ref(model_dir=bundles[family])
    rs = np.random.RandomState(9)
    speech = (12.0 + 3.0 * rs.standard_normal((2, 160, FEAT))).astype(
        np.float32)
    lens = np.asarray([160, 121])
    enc, probs, out_lens = port.encode_for_rescoring(speech, lens)
    jenc, jprobs, jlens = ref.encode_for_rescoring(speech, lens)
    np.testing.assert_array_equal(out_lens, jlens)
    np.testing.assert_allclose(probs, jprobs, atol=3e-5, rtol=0)
    for i in range(2):
        hyps = _hyps(rs, 12, 1, 11)
        got = port.rescore(enc[i:i + 1], out_lens[i], hyps,
                           reverse_weight=0.3)
        want = ref.rescore(jenc[i:i + 1], jlens[i], hyps,
                           reverse_weight=0.3)
        assert got.shape == want.shape == (10,)
        np.testing.assert_allclose(got, want, atol=SCORE_ATOL, rtol=0)
        exact, exact_lens = _pad(hyps[:10], 10, 1)
        whole = port.model.rescore_hyps(
            enc[i:i + 1], int(out_lens[i]), torch.from_numpy(exact),
            torch.from_numpy(exact_lens), reverse_weight=0.3).numpy()
        np.testing.assert_allclose(got, whole, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------- #
# MASRPredictor and the engine on the trained example bundle
# ---------------------------------------------------------------------- #
def _render(text, spk):
    from masr_tpu_torch.audio.synth_tts import SyntheticTTS
    return SyntheticTTS(sample_rate=16000).render(text, spk_id=spk)


@pytest.fixture(scope="module")
def wavs():
    return [_render(t, s) for t, s in HELD_OUT]


@pytest.fixture(scope="module")
def corpus_lm(tmp_path_factory):
    """A character bigram ARPA of the bundle's training sentences
    (chip_smoke.py writes the same)."""
    import chip_smoke
    path = str(tmp_path_factory.mktemp("lm") / "bigram.arpa")
    return chip_smoke.write_char_bigram_arpa(chip_smoke.corpus_sentences(),
                                             path)


CASES = {"beam": ("ctc_beam_search", False),
         "beam_lm": ("ctc_beam_search", True),
         "rescoring": ("attention_rescoring", False),
         "device": ("ctc_beam_search_device", False),
         "device_lm": ("ctc_beam_search_device", True)}


def _conf(decoder, lm):
    conf = dict(beam_size=10, cutoff_top_n=40) \
        if decoder == "ctc_beam_search_device" \
        else dict(beam_size=50, alpha=2.2, beta=4.3, cutoff_prob=0.99,
                  cutoff_top_n=40, rescoring_nbest=10)
    if lm:
        conf["language_model_path"] = lm
    return conf


def _predictors(case, lm, fused=True):
    from masr_tpu.infer.predictor import MASRPredictor as Ref
    from masr_tpu_torch.infer.predictor import MASRPredictor
    decoder, with_lm = CASES[case]
    conf = _conf(decoder, lm if with_lm else None)
    port = MASRPredictor(EXAMPLE, decoder=decoder, decoder_configs=conf,
                         device="cpu", warmup=False, fused_frontend=fused)
    ref = Ref(EXAMPLE, decoder=decoder, decoder_configs=dict(conf),
              warmup=False, fused_frontend=fused)
    assert port.decoder == ref.decoder == decoder
    if port.beam_search_decoder is not None:
        assert port.beam_search_decoder.engine == "native"
    return port, ref


def _stream(pred, wav, piece=PIECE):
    out = None
    for i in range(0, len(wav), piece):
        r = pred.predict_stream(wav[i:i + piece],
                                is_end=i + piece >= len(wav))
        out = r if r is not None else out
    pred.reset_stream()
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_predict_and_batch_equal_masr_tpu(case, corpus_lm, wavs):
    """predict and predict_batch: masr_tpu's texts, scores within 1e-3
    (under attention_rescoring both packages' predict_batch decode
    greedily, their predict rescores)."""
    port, ref = _predictors(case, corpus_lm)
    got = [port.predict(w) for w in wavs]
    want = [ref.predict(w) for w in wavs]
    assert [g["text"] for g in got] == [w["text"] for w in want]
    for g, w in zip(got, want):
        assert abs(g["score"] - w["score"]) <= 1e-3
    batch = port.predict_batch(wavs)
    want = ref.predict_batch(wavs)
    assert [b["text"] for b in batch] == [w["text"] for w in want]
    for b, w in zip(batch, want):
        assert abs(b["score"] - w["score"]) <= 1e-3
    if case != "rescoring":
        assert [b["text"] for b in batch] == [g["text"] for g in got]
        hits = sum(g["text"] == t for g, (t, _) in zip(got, HELD_OUT))
        assert hits >= 2


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "host"])
@pytest.mark.parametrize("case", ["beam", "rescoring", "device_lm"])
def test_predict_stream_equals_masr_tpu(case, fused, corpus_lm, wavs):
    """predict_stream in 0.2 s pieces, two-pass for attention_rescoring:
    masr_tpu's text (and score within 1e-3), both frontends; reset_stream
    isolates utterances."""
    port, ref = _predictors(case, corpus_lm, fused)
    for w in wavs[:2]:
        got, want = _stream(port, w), _stream(ref, w)
        assert got["text"] == want["text"]
        assert abs(got["score"] - want["score"]) <= 1e-3
    if case == "rescoring":
        assert port._stream_hidden == []
    again = _stream(port, wavs[0])
    assert again["text"] == _stream(ref, wavs[0])["text"]


def test_two_pass_rescores_every_window(wavs):
    """The end-of-stream rescoring runs once, over the encoder rows of
    every window (as many rows as the windows' valid output frames)."""
    from masr_tpu_torch.infer.predictor import MASRPredictor
    port = MASRPredictor(EXAMPLE, decoder="attention_rescoring",
                         decoder_configs=_conf("attention_rescoring", None),
                         device="cpu", warmup=False)
    calls, orig = [], port._pick_rescored
    port._pick_rescored = lambda enc, n, nbest: (
        calls.append((enc.shape, n)), orig(enc, n, nbest))[1]
    wav = wavs[1]
    rows = 0
    for i in range(0, len(wav), PIECE):
        r = port.predict_stream(wav[i:i + PIECE],
                                is_end=i + PIECE >= len(wav))
        rows = sum(h.shape[1] for h in port._stream_hidden)
    assert len(calls) == 1 and calls[0][1] == rows > 0
    assert calls[0][0] == (1, rows, 48)
    assert r["text"]


def _interleaved(sess, waves, step):
    slots = [sess.open() for _ in waves]
    texts = [None] * len(waves)
    for i in range(max(len(w) for w in waves) // step + 1 + len(waves)):
        items = [(slot, waves[k][(i - k) * step:(i - k + 1) * step],
                  (i - k + 1) * step >= len(waves[k]))
                 for k, slot in enumerate(slots)
                 if i >= k and (i - k) * step < len(waves[k])]
        if items:
            for slot, r in sess.feed_many(items).items():
                if r is not None:
                    texts[slots.index(slot)] = r["text"]
    for slot in slots:
        sess.close(slot)
    return texts


def test_engine_device_beam_equals_masr_tpu(corpus_lm, wavs):
    """BatchStreamSession(decoder='ctc_beam_search_device') with the
    dense bigram: three staggered streams give masr_tpu's engine's texts
    and the port's own predict_stream texts; a closed slot reopens with a
    fresh beam. The engine refuses a piece of digital silence (dB
    normalization, as masr_tpu's does), so the streams get a noise
    floor."""
    from masr_tpu.infer.batch_stream import BatchStreamSession as Ref
    from masr_tpu_torch.infer.batch_stream import BatchStreamSession
    port, ref = _predictors("device_lm", corpus_lm, fused=False)
    conf = dict(beam_size=10, cutoff_top_n=40, alpha=2.2, beta=4.3)
    pre = port.predictor.meta["preprocess_conf"]
    sess = BatchStreamSession(
        port.predictor, port._vocab_list, preprocess_conf=pre,
        max_streams=4, decoder="ctc_beam_search_device",
        decoder_conf=dict(conf, lm_table=port._device_beam_conf["lm_table"]))
    jsess = Ref(ref.predictor, ref._text_featurizer.vocab_list,
                preprocess_conf=pre, max_streams=4,
                decoder="ctc_beam_search_device",
                decoder_conf=dict(conf, lm_table=np.asarray(
                    ref._device_beam_conf["lm_table"])))
    rs = np.random.RandomState(2)
    wavs = [w + 1e-3 * rs.standard_normal(len(w)).astype(np.float32)
            for w in wavs]
    got = _interleaved(sess, wavs, 4000)
    assert got == _interleaved(jsess, wavs, 4000)
    assert got == [_stream(port, w, len(w))["text"] for w in wavs]
    assert sum(g == t for g, (t, _) in zip(got, HELD_OUT)) >= 2
    slot = sess.open()
    assert sess.feed(slot, wavs[2], is_end=True)["text"] == got[2]


@pytest.mark.parametrize("decoder", ["ctc_greedy", "attention_rescoring"])
def test_engine_refuses_other_decoders(decoder, wavs):
    from masr_tpu_torch.infer.batch_stream import BatchStreamSession
    from masr_tpu_torch.infer.predictor import MASRPredictor
    port = MASRPredictor(EXAMPLE, device="cpu", warmup=False)
    if decoder == "ctc_greedy":
        sess = BatchStreamSession(port.predictor, port._vocab_list,
                                  decoder=decoder)
        assert sess._dec_state is None
    else:
        with pytest.raises(ValueError, match=decoder):
            BatchStreamSession(port.predictor, port._vocab_list,
                               decoder=decoder)


def test_beam_unavailable_falls_back_to_greedy(monkeypatch, wavs):
    """A beam decoder that cannot be built: a warning and greedy decoding,
    as masr_tpu's predictor does."""
    from masr_tpu_torch.decoders import beam_search
    from masr_tpu_torch.infer import predictor as pr

    class Broken(beam_search.BeamSearchDecoder):
        def __init__(self, *a, **k):
            raise RuntimeError("no engine")

    monkeypatch.setattr(pr, "BeamSearchDecoder", Broken)
    port = pr.MASRPredictor(EXAMPLE, decoder="ctc_beam_search",
                            device="cpu", warmup=False)
    assert port.decoder == "ctc_greedy" and port.beam_search_decoder is None
    greedy = pr.MASRPredictor(EXAMPLE, device="cpu", warmup=False)
    assert port.predict(wavs[0]) == greedy.predict(wavs[0])


def test_rescore_hyps_ignores_training_mode(bundles):
    """rescore_hyps runs its decoder without dropout in either mode (as
    masr_tpu calls it with train=False) and leaves the mode as it was."""
    _, _, port = _models(bundles["conformer"])
    rs = np.random.RandomState(5)
    enc = torch.from_numpy(rs.standard_normal((1, 17, 64)).astype(
        np.float32))
    h, hl = (torch.from_numpy(a) for a in _pad(_hyps(rs, 4), 4, 1))
    want = port.rescore_hyps(enc, 17, h, hl, reverse_weight=0.3)
    port.train()
    got = port.rescore_hyps(enc, 17, h, hl, reverse_weight=0.3)
    assert port.decoder.training
    assert torch.equal(got, want)
