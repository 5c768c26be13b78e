"""The port's DeepSpeech2 (masr_tpu_torch/models/deepspeech2.py) against
masr_tpu's flax modules on the CPU, at small widths: F=16 features into
the modules, 2 recurrent layers of H=24 (32 in the bundles, whose fbank
has 80 bins), every parameter perturbed away from its init, inputs from a
numpy seed.

Tolerances, f32 on the CPU in another sum order:
- a recurrent layer (LSTM and GRU, forward and bidirectional) against
  flax's nn.RNN route and its fast_scan route: outputs on the valid frames
  and the final h and c, atol 1e-5 (frames past a length differ by design:
  packed outputs are 0 there);
- the conv entry: outputs exactly the frames masr_tpu gives, atol 1e-5;
- CTC probs of a bundle (the head x8, as the other families' tests):
  atol 3e-5 over the valid frames; chained chunk steps: probs atol 3e-5,
  the carried h and c atol 1e-5;
- the weight map flax → port → flax: bit for bit; an upstream-named state
  dict through load_upstream_state_dict against masr_tpu's
  convert_deepspeech2 route: probs atol 3e-5;
- texts of predict, predict_batch, predict_stream (both frontends, whole
  and in 0.2 s pieces), the engine and the attention_rescoring fallback:
  equal to masr_tpu's.
The loss, the grads, the trainer, export and eval are in
tests/test_torch_ds2_training.py.
"""
import logging

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict

from masr_tpu.models import deepspeech2 as jd
from masr_tpu.models.cmvn import GlobalCMVN as FlaxCMVN
from masr_tpu.models.subsampling import \
    Conv2dSubsampling4Pure as FlaxPureConv
from masr_tpu_torch.models import deepspeech2 as pd
from masr_tpu_torch.models.cmvn import GlobalCMVN
from masr_tpu_torch.models.registry import build_model
from masr_tpu_torch.models.subsampling import (Conv2dSubsampling4Pure,
                                               subsampling_class)
from masr_tpu_torch.models.weights import (from_flax_variables,
                                           load_upstream_state_dict,
                                           to_flax_variables)
from test_torch_threads import one_torch_thread  # noqa: F401

F, H = 16, 24
FEAT = 80
VOCAB = ["<blank>", "<unk>", "你", "好", "天", "气", "<space>", "<eos>"]
WIN, STRIDE = 67, 64                 # a feature window and its stride
PIECE = 3200                         # 0.2 s at 16 kHz
FORMS = [(False, True), (True, True), (False, False), (True, False)]
FORM_IDS = ["lstm-forward", "gru-forward", "lstm-bidirect", "gru-bidirect"]


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=0)


def _perturb(variables, seed, scale=0.05):
    """Every leaf moved off its init: ones (scales) by +|N|·scale, the
    rest by N·scale."""
    rs = np.random.RandomState(seed)
    leaves, treedef = jax.tree.flatten(variables)
    return jax.tree.unflatten(treedef, [
        (np.asarray(l) + (np.abs(rs.standard_normal(l.shape))
                          if l.size and float(np.min(l)) >= 0.9
                          else rs.standard_normal(l.shape)) * scale
         ).astype(np.float32) for l in leaves])


def _data(B=4, T=21, D=F, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((B, T, D)).astype(np.float32)
    return x, np.asarray([T, T - 3, 9, 14][:B])


# --------------------------------------------------------------------------- #
# modules
# --------------------------------------------------------------------------- #
def _port_layer(layer_params, D, use_gru, bidirectional):
    """A port RNNLayer holding flax RNNLayer params: the layer goes through
    the model's weight map as rnn_0 behind a one-channel conv (whose
    first-layer column permutation is the identity)."""
    tree = {"encoder": {"conv": {
        c: {"kernel": np.zeros((3, 3, 1, 1), np.float32),
            "bias": np.zeros(1, np.float32)} for c in ("conv1", "conv2")},
        "rnn_0": layer_params},
        "ctc": {"ctc_lo": {"kernel": np.zeros((1, 1), np.float32),
                           "bias": np.zeros(1, np.float32)}}}
    state = {k[len("encoder.rnns.0."):]: v
             for k, v in from_flax_variables({"params": tree}).items()
             if k.startswith("encoder.rnns.0.")}
    layer = pd.RNNLayer(D, H, bidirectional, use_gru)
    layer.load_state_dict(state)
    return layer.eval()


@pytest.mark.parametrize("fast", [False, True], ids=["nn_rnn", "fast_scan"])
@pytest.mark.parametrize("use_gru,streaming", FORMS, ids=FORM_IDS)
def test_rnn_layer_matches_flax(use_gru, streaming, fast):
    """One recurrent layer from a carry h0 (and c0): outputs on the valid
    frames and the final h and c (the forward direction's, at len − 1)
    against flax's layer on either route."""
    x, lens = _data(seed=1)
    flax_layer = jd.RNNLayer(H, bidirectional=not streaming,
                             use_gru=use_gru, fast_scan=fast)
    rs = np.random.RandomState(2)
    h0 = (0.3 * rs.standard_normal((4, H))).astype(np.float32)
    c0 = (0.3 * rs.standard_normal((4, H))).astype(np.float32)
    v = flax_layer.init(jax.random.PRNGKey(0), jnp.asarray(x),
                        jnp.asarray(lens), jnp.asarray(h0), jnp.asarray(c0))
    v = _perturb(v, 3)
    want = flax_layer.apply(v, jnp.asarray(x), jnp.asarray(lens),
                            jnp.asarray(h0), jnp.asarray(c0))
    layer = _port_layer(v["params"], F, use_gru, not streaming)
    with torch.no_grad():
        y, hT, cT = layer(_t(x), torch.from_numpy(lens), _t(h0), _t(c0))
    for b, n in enumerate(lens):
        _close(y[b, :n], np.asarray(want[0])[b, :n])
    _close(hT, want[1])
    _close(cT, want[2])
    if not use_gru:
        assert float(np.abs(np.asarray(want[2])).max()) > 0.1


def test_conv_subsampling_matches_flax():
    """Conv2dSubsampling4Pure: the flattened features (c-major here, f-major
    in flax: the weight map permutes the first layer's columns, so the
    comparison reorders them) and the length formula; DeepSpeech2's conv2d
    is this class, the other families' is not."""
    x, lens = _data(T=37, seed=4)
    flax_conv = FlaxPureConv(F, 32)
    v = _perturb(flax_conv.init(jax.random.PRNGKey(1), jnp.asarray(x)), 5)
    want, want_l = flax_conv.apply(v, jnp.asarray(x), jnp.asarray(lens))
    conv = Conv2dSubsampling4Pure(F, 32)
    p = v["params"]
    with torch.no_grad():
        for i, name in ((0, "conv1"), (2, "conv2")):
            conv.conv[i].weight.copy_(_t(np.transpose(p[name]["kernel"],
                                                      (3, 2, 0, 1))))
            conv.conv[i].bias.copy_(_t(p[name]["bias"]))
        got, got_l = conv(_t(x), torch.from_numpy(lens))
    B, T, D = got.shape
    assert D == conv.output_dim == flax_conv.output_dim == 32 * 3
    f_major = got.reshape(B, T, 32, -1).transpose(2, 3).reshape(B, T, D)
    _close(f_major, want)
    assert got_l.tolist() == np.asarray(want_l).tolist() == [8, 7, 1, 2]
    assert subsampling_class("conv2d", "deepspeech2") is \
        Conv2dSubsampling4Pure
    assert subsampling_class("conv2d") is not Conv2dSubsampling4Pure


def _flax_model(use_gru, streaming, seed, D=F, rnn_size=H, vocab=12):
    model = jd.DeepSpeech2Model(
        input_dim=D, vocab_size=vocab, streaming=streaming,
        encoder_conf=dict(num_rnn_layers=2, rnn_size=rnn_size,
                          use_gru=use_gru))
    v = model.init({"params": jax.random.PRNGKey(seed)},
                   jnp.zeros((1, WIN, D)), jnp.asarray([WIN]),
                   jnp.ones((1, 3), jnp.int32), jnp.asarray([3]))
    return model, _perturb(v, seed)


def _port_model(use_gru, streaming, variables, D=F, rnn_size=H, vocab=12):
    model = build_model("deepspeech2", D, vocab, streaming=streaming,
                        encoder_conf=dict(num_rnn_layers=2,
                                          rnn_size=rnn_size,
                                          use_gru=use_gru))
    model.load_state_dict(from_flax_variables(variables))
    return model.eval()


@pytest.mark.parametrize("caller", [True, False], ids=["tf32_on",
                                                      "tf32_off"])
def test_encoder_runs_full_f32_and_keeps_the_callers_tf32(caller):
    """The encoder turns cuDNN's TF32 off for its conv and recurrence, and
    gives the caller's setting back when it returns (on a CPU tensor too:
    the flag is a process setting, whatever the device), also when the
    forward raises."""
    model = build_model("deepspeech2", F, 12, encoder_conf=dict(
        num_rnn_layers=2, rnn_size=H))
    seen = []
    for m in (model.encoder.conv, *model.encoder.rnns):
        m.register_forward_pre_hook(
            lambda *_: seen.append(torch.backends.cudnn.allow_tf32))
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = caller
    try:
        with torch.no_grad():
            model.get_encoder_out(torch.zeros(2, WIN, F),
                                  torch.tensor([WIN, WIN - 9]))
        assert seen == [False] * 3
        assert torch.backends.cudnn.allow_tf32 is caller
        with pytest.raises(RuntimeError):
            model.encoder(torch.zeros(2, WIN, 2 * F))
        assert torch.backends.cudnn.allow_tf32 is caller
    finally:
        torch.backends.cudnn.allow_tf32 = prev


@pytest.mark.parametrize("use_gru,streaming", FORMS, ids=FORM_IDS)
def test_weight_round_trip_is_exact(use_gru, streaming):
    """flax → port → flax gives every leaf back bit for bit, and the port's
    state holds what flax's cells lack as 0 (an LSTM's bias_ih, a GRU's
    b_hr and b_hz)."""
    _, v = _flax_model(use_gru, streaming, 6)
    state = from_flax_variables(v)
    back = flatten_dict(to_flax_variables(state)["params"])
    want = flatten_dict(v["params"])
    assert sorted(back) == sorted(want)
    for k in want:
        assert back[k].dtype == np.float32 and \
            back[k].tobytes() == np.asarray(want[k]).tobytes(), k
    for rev in ([""] if streaming else ["", "_reverse"]):
        b_ih = state["encoder.rnns.1.rnn.bias_ih_l0" + rev]
        b_hh = state["encoder.rnns.1.rnn.bias_hh_l0" + rev]
        assert not (b_ih.any() if not use_gru else b_hh[:2 * H].any())


@pytest.mark.parametrize("use_gru", [False, True], ids=["lstm", "gru"])
def test_upstream_state_dict_matches_convert_route(use_gru):
    """An upstream-named DS2 state dict (every bias non-zero, the RNN one
    level deeper and the head under decoder.ctc_lo, as masr_tpu's converter
    accepts) through load_upstream_state_dict == the same dict through
    convert_deepspeech2 into masr_tpu's model: probs within 3e-5."""
    from masr_tpu.models.convert import apply_converted, convert_deepspeech2
    model = build_model("deepspeech2", F, 12, streaming=True,
                        encoder_conf=dict(num_rnn_layers=2, rnn_size=H,
                                          use_gru=use_gru))
    rs = np.random.RandomState(7)
    upstream = {}
    for k, p in model.state_dict().items():
        k = k.replace(".rnn.", ".rnn.rnn.").replace("ctc.ctc_lo",
                                                    "decoder.ctc_lo")
        upstream[k] = (0.2 * rs.standard_normal(tuple(p.shape))).astype(
            np.float32)
    load_upstream_state_dict(model, upstream)
    jmodel, v = _flax_model(use_gru, True, 0)
    converted, misses = convert_deepspeech2(upstream, F)
    assert not misses
    params = apply_converted(v["params"], converted, strict=True)
    x, lens = _data(T=45, seed=8)
    want, want_l = jmodel.apply({"params": params}, jnp.asarray(x),
                                jnp.asarray(lens),
                                method=jd.DeepSpeech2Model.get_encoder_out)
    with torch.no_grad():
        got, got_l = model.eval().get_encoder_out(_t(x),
                                                  torch.from_numpy(lens))
    assert got_l.tolist() == np.asarray(want_l).tolist()
    for b, n in enumerate(got_l.tolist()):
        _close(got[b, :n], np.asarray(want)[b, :n], 3e-5)


@pytest.mark.parametrize("use_gru,streaming", FORMS, ids=FORM_IDS)
def test_model_probs_match_masr_tpu(use_gru, streaming):
    """get_encoder_out with CMVN: lengths equal, CTC probs within 3e-5 over
    the valid frames (one utterance of 0 output frames)."""
    jmodel, v = _flax_model(use_gru, streaming, 9)
    cmvn = (np.full(F, 0.5), np.full(F, 0.8))
    jmodel = jmodel.clone(cmvn=FlaxCMVN(*cmvn))
    port = _port_model(use_gru, streaming, v)
    port.encoder.global_cmvn = GlobalCMVN(*cmvn)
    x, _ = _data(T=57, seed=10)
    lens = np.asarray([57, 44, 5, 30])
    want, want_l = jmodel.apply(v, jnp.asarray(x), jnp.asarray(lens),
                                method=jd.DeepSpeech2Model.get_encoder_out)
    with torch.no_grad():
        got, got_l = port.get_encoder_out(_t(x), torch.from_numpy(lens))
    assert got_l.tolist() == np.asarray(want_l).tolist() == [13, 10, 0, 6]
    for b, n in enumerate(got_l.tolist()):
        _close(got[b, :n], np.asarray(want)[b, :n], 3e-5)


@pytest.mark.parametrize("use_gru", [False, True], ids=["lstm", "gru"])
def test_chunk_chain_matches_masr_tpu(use_gru):
    """get_encoder_out_chunk over 67-frame windows at a 64-frame stride,
    the h/c carry threaded through: every window's probs (3e-5) and the
    carry after each (1e-5) against masr_tpu's chain; the carry is updated
    in place."""
    jmodel, v = _flax_model(use_gru, True, 11)
    port = _port_model(use_gru, True, v)
    x, _ = _data(B=2, T=WIN + 3 * STRIDE, seed=12)
    state = port.init_cache(batch=2)
    h_store = state["h"]
    jstate = jmodel.apply(v, batch=2,
                          method=jd.DeepSpeech2Model.init_cache)
    for start in range(0, x.shape[1] - WIN + 1, STRIDE):
        win = x[:, start:start + WIN]
        want, jstate = jmodel.apply(
            v, jnp.asarray(win), jstate,
            method=jd.DeepSpeech2Model.get_encoder_out_chunk)
        with torch.no_grad():
            got = port.get_encoder_out_chunk(_t(win), state)
        assert got.shape == (2, 16, 12)
        _close(got, want, 3e-5)
        _close(state["h"], jstate["h"])
        _close(state["c"], jstate["c"])
    assert state["h"] is h_store and float(h_store.abs().max()) > 0.1


def test_batched_step_keeps_inactive_slots():
    """The engine's step: active slots take the carry of a lone step,
    inactive ones keep theirs bit for bit."""
    _, v = _flax_model(False, True, 13)
    port = _port_model(False, True, v)
    x, _ = _data(B=3, T=WIN, seed=14)
    states = port.init_cache(batch=3)
    states["h"].normal_(generator=torch.Generator().manual_seed(0))
    before = {k: t.clone() for k, t in states.items()}
    with torch.no_grad():
        port.get_encoder_out_chunk_batched(
            _t(x), states, active=torch.tensor([True, False, True]))
        lone = {k: t[:, 2:3].clone() for k, t in before.items()}
        port.get_encoder_out_chunk(_t(x[2:3]), lone)
    for k in ("h", "c"):
        assert torch.equal(states[k][:, 1], before[k][:, 1])
        _close(states[k][:, 2:3], lone[k].numpy(), 1e-6)
        assert not torch.equal(states[k][:, 0], before[k][:, 0])


# --------------------------------------------------------------------------- #
# bundles: the predictor and the engine
# --------------------------------------------------------------------------- #
def _export(out, use_gru, streaming, seed):
    """A DS2 bundle that masr_tpu exports (fbank 80, 2 layers of 32),
    weights from a seed, perturbed, the CTC head x8 → the bundle dir. dB
    normalization is off (its gain is taken over each call's buffer, see
    tests/test_torch_efficient_conformer.py)."""
    from masr_tpu.infer.bundle import save_inference_bundle
    enc = dict(num_rnn_layers=2, rnn_size=32, use_gru=use_gru)
    _, v = _flax_model(use_gru, streaming, seed, D=FEAT, rnn_size=32,
                       vocab=len(VOCAB))
    v["params"]["ctc"]["ctc_lo"] = {
        k: t * 8.0 for k, t in v["params"]["ctc"]["ctc_lo"].items()}
    save_inference_bundle(out, "deepspeech2", streaming, FEAT, VOCAB,
                          np.full(FEAT, 15.0), np.full(FEAT, 0.33), enc, {},
                          {}, {"feature_method": "fbank", "n_mels": FEAT,
                               "use_dB_normalization": False}, v)
    return out


BUNDLES = {"lstm": (False, True, 21), "gru": (True, True, 22),
           "lstm_bidirect": (False, False, 23)}


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    return {name: _export(str(tmp_path_factory.mktemp(name)), *args)
            for name, args in BUNDLES.items()}


def _wave(seed, n_chars):
    """Speech-like audio from the synthetic voice over a noise floor."""
    from masr_tpu_torch.audio.synth_tts import SyntheticTTS
    rs = np.random.RandomState(seed)
    text = "".join(rs.choice(list("上家音月火少风大你下雪蓝右黑真"), n_chars))
    wav = SyntheticTTS(sample_rate=16000).render(text, spk_id=seed % 4)
    return wav + 1e-3 * rs.standard_normal(len(wav)).astype(np.float32)


def _predictors(model_dir, fused=True, decoder="ctc_greedy", conf=None):
    from masr_tpu.infer.predictor import MASRPredictor as JaxPredictor
    from masr_tpu_torch.infer.predictor import MASRPredictor
    return (MASRPredictor(model_dir=model_dir, device="cpu", warmup=False,
                          fused_frontend=fused, decoder=decoder,
                          decoder_configs=conf),
            JaxPredictor(model_dir=model_dir, warmup=False,
                         fused_frontend=fused, decoder=decoder,
                         decoder_configs=conf))


@pytest.mark.parametrize("name", sorted(BUNDLES))
def test_predict_and_predict_batch_match_masr_tpu(bundles, name):
    """Same texts (scores within 1e-3), one by one and as a batch, for the
    LSTM and GRU streaming bundles and the bidirectional offline one."""
    port, ref = _predictors(bundles[name])
    wavs = [_wave(s, n) for s, n in ((0, 9), (1, 4), (2, 14))]
    got = [port.predict(w) for w in wavs]
    want = [ref.predict(w) for w in wavs]
    assert [g["text"] for g in got] == [w["text"] for w in want]
    for g, w in zip(got, want):
        assert abs(g["score"] - w["score"]) <= 1e-3
    assert [g["text"] for g in port.predict_batch(wavs)] == \
        [w["text"] for w in ref.predict_batch(wavs)]
    assert len({g["text"] for g in got}) == 3 and all(g["text"] for g in got)


def _stream(predictor, wav, piece=None):
    piece = piece or len(wav)
    out = None
    for i in range(0, len(wav), piece):
        r = predictor.predict_stream(wav[i:i + piece],
                                     is_end=i + piece >= len(wav),
                                     sample_rate=16000)
        out = r if r is not None else out
    predictor.reset_stream()
    return out["text"]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "host"])
@pytest.mark.parametrize("name", ["lstm", "gru"])
def test_predict_stream_matches_masr_tpu(bundles, name, fused):
    """Whole and in 0.2 s pieces: the port's text equals masr_tpu's for the
    same feeding, and the state is the model's h/c carry."""
    port, ref = _predictors(bundles[name], fused)
    texts = []
    for seed, n_chars in ((0, 11), (1, 4)):
        wav = _wave(seed, n_chars)
        for piece in (None, PIECE):
            got, want = _stream(port, wav, piece), _stream(ref, wav, piece)
            assert got == want, (seed, piece)
            texts.append(got)
    assert texts[0] != texts[2] and all(texts)
    port.predict_stream(_wave(3, 8))
    assert sorted(port.predictor.state) == ["c", "h"]
    assert tuple(port.predictor.state["h"].shape) == (2, 1, 32)


def _interleaved(sess, waves, step):
    """Stream k starts k pieces late; all ready slots go through feed_many
    → the final text of every stream."""
    slots = [sess.open() for _ in waves]
    texts = [None] * len(waves)
    for i in range(max(len(w) for w in waves) // step + 1 + len(waves)):
        items = [(slot, waves[k][(i - k) * step:(i - k + 1) * step],
                  (i - k + 1) * step >= len(waves[k]))
                 for k, slot in enumerate(slots)
                 if i >= k and (i - k) * step < len(waves[k])]
        for slot, r in sess.feed_many(items).items():
            if r is not None:
                texts[slots.index(slot)] = r["text"]
    for slot in slots:
        sess.close(slot)
    return texts


@pytest.mark.parametrize("decoder", ["ctc_greedy", "ctc_beam_search_device"])
def test_engine_matches_masr_tpu(bundles, decoder):
    """Three staggered streams through BatchStreamSession (h/c slots, one
    dispatch per tick, nothing packed, tick_chunks=2 falls back to 1):
    masr_tpu's engine's texts and the port's own predict_stream texts; a
    closed slot's carry is zeroed and a reopened one gives the same text
    again."""
    from masr_tpu.infer.batch_stream import \
        BatchStreamSession as JaxSession
    from masr_tpu_torch.infer.batch_stream import BatchStreamSession
    port, ref = _predictors(bundles["lstm"], fused=False)
    conf = port.predictor.meta["preprocess_conf"]
    dec = dict(beam_size=4, cutoff_top_n=8)
    waves = [_wave(20 + s, 5 + 4 * s) for s in range(3)]
    sess = BatchStreamSession(port.predictor, port._vocab_list,
                              preprocess_conf=conf, max_streams=4,
                              tick_chunks=2, decoder=decoder,
                              decoder_conf=dec)
    assert sess.tick_k == 1 and sess._packed_chunk is None
    assert tuple(sess.states["h"].shape) == (2, 4, 32)
    got = _interleaved(sess, waves, 4000)
    assert not sess.states["h"].any() and not sess.states["c"].any()
    want = _interleaved(JaxSession(ref.predictor,
                                   ref._text_featurizer.vocab_list,
                                   preprocess_conf=conf, max_streams=4,
                                   decoder=decoder, decoder_conf=dec),
                        waves, 4000)
    assert got == want
    if decoder == "ctc_greedy":
        assert got == [_stream(port, w) for w in waves]
    assert len(set(got)) == 3
    assert _interleaved(sess, waves[::-1], 4000) == got[::-1]


@pytest.mark.parametrize("name", ["lstm", "lstm_bidirect"])
def test_attention_rescoring_falls_back_to_beam_search(bundles, name,
                                                       caplog):
    """DeepSpeech2 has no attention decoder: attention_rescoring becomes
    ctc_beam_search with a warning, as in masr_tpu; predict, predict_batch
    and (streaming) predict_stream give masr_tpu's texts."""
    conf = dict(beam_size=8, cutoff_top_n=8)
    logger = logging.getLogger("masr_tpu_torch")
    logger.addHandler(caplog.handler)      # the port's logger may not propagate
    try:
        port, ref = _predictors(bundles[name], decoder="attention_rescoring",
                                conf=conf)
    finally:
        logger.removeHandler(caplog.handler)
    assert port.decoder == ref.decoder == "ctc_beam_search"
    assert "no attention decoder" in caplog.text
    wavs = [_wave(s, n) for s, n in ((4, 7), (5, 12))]
    assert [port.predict(w)["text"] for w in wavs] == \
        [ref.predict(w)["text"] for w in wavs]
    assert [r["text"] for r in port.predict_batch(wavs)] == \
        [r["text"] for r in ref.predict_batch(wavs)]
    if port.streaming:
        assert [_stream(port, w, PIECE) for w in wavs] == \
            [_stream(ref, w, PIECE) for w in wavs]
