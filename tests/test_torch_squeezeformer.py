"""The port's Squeezeformer (masr_tpu_torch/models/squeezeformer.py,
ops/cuda/squeezeformer_layer.py) against masr_tpu, on the CPU, at the sizes
of tests/test_fused_squeezeformer.py (D=64, 2 heads, 3 blocks, reduce 1 /
recover 2, FFN expansion 2, conv kernel 7), every parameter and BatchNorm
statistic perturbed away from its init.

- The weight map: flax → port → flax with params and batch_stats, bit for
  bit; every upstream name is in convert_squeezeformer's input grammar and
  maps to the same flax array.
- The full-context layer: the plain twin against the Pallas kernel
  `fused_squeezeformer_layer` in interpret mode and against the flax
  SqueezeformerEncoderLayer (and the port's eager layer), causal and not,
  BatchNorm and layer_norm conv norms, adaptive scale on and off, ragged
  lens: atol 1e-4 (f32, another sum order, the adaptive scales folded into
  the weights).
- The model at full context: encoder output (atol 2e-5: post-norm rows of
  magnitude ~4) and CTC probs (atol 3e-5: the bundle's CTC head is x8)
  against flax (XLA path) with
  the `stream` and the `conv1d` time reduction, lengths odd after the
  reduction.
- The entry points on a tiny seeded Squeezeformer bundle that masr_tpu
  exports: predict and predict_batch; predict_stream with the fused and
  the host frontend, whole and in 0.2 s pieces; BatchStreamSession with
  feed_many, slot reuse and multi-chunk ticks. Texts equal masr_tpu's.
The CUDA kernels are held against the plain twins in
tests/test_torch_cuda_kernels.py.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from masr_tpu.models.squeezeformer import \
    SqueezeformerEncoderLayer as FlaxLayer
from masr_tpu.ops.pallas import squeezeformer_layer as jsq
from masr_tpu_torch.models.squeezeformer import SqueezeformerEncoderLayer
from masr_tpu_torch.models.weights import (from_flax_variables,
                                           to_flax_variables)
from masr_tpu_torch.ops.cuda import squeezeformer_layer as sq
from test_torch_threads import one_torch_thread  # noqa: F401

D, H, K, FF = 64, 2, 7, 128
FEAT = 80
ENC = dict(encoder_dim=D, output_size=D, attention_heads=H, num_blocks=3,
           reduce_idx=1, recover_idx=2, feed_forward_expansion_factor=2,
           cnn_module_kernel=K)
DEC = dict(attention_heads=2, linear_units=32, num_blocks=1, r_num_blocks=0)
VOCAB = ["<blank>", "<unk>", "你", "好", "天", "<space>", "<eos>"]
PIECE = 3200                                          # 0.2 s at 16 kHz


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _perturb(variables, seed, scale=0.05):
    """Every leaf moved off its init: ones (scales, BatchNorm variances)
    by +|N|·scale, the rest by N·scale (a zero bias once hid a parity
    bug)."""
    rs = np.random.RandomState(seed)
    leaves, treedef = jax.tree.flatten(variables)
    return jax.tree.unflatten(treedef, [
        (np.asarray(l) + (np.abs(rs.standard_normal(l.shape))
                          if l.size and float(np.min(l)) >= 0.9
                          else rs.standard_normal(l.shape)) * scale
         ).astype(np.float32) for l in leaves])


def _load(module, variables, prefix):
    """Load the flax variables into the port's module (num_batches_tracked
    is not in a flax tree)."""
    sd = {k[len(prefix):]: v for k, v in from_flax_variables(variables).items()
          if k.startswith(prefix)}
    missing, unexpected = module.load_state_dict(sd, strict=False)
    assert not unexpected
    assert all(k.endswith("num_batches_tracked") for k in missing), missing
    return module.eval()


# --------------------------------------------------------------------------- #
# the full-context layer
# --------------------------------------------------------------------------- #
def _flax_layer(seed, causal, cnn_norm, adaptive_scale):
    layer = FlaxLayer(size=D, attention_heads=H, ffn_units=FF,
                      dropout_rate=0.0, attention_dropout_rate=0.0,
                      cnn_module_kernel=K, cnn_norm=cnn_norm, causal=causal,
                      adaptive_scale=adaptive_scale)
    x = jnp.zeros((1, 8, D))
    mask = jnp.ones((1, 1, 8), bool)
    v = layer.init(jax.random.PRNGKey(seed), x, mask, x, mask)
    return layer, _perturb(v, seed)


@pytest.mark.parametrize("causal,cnn_norm,adaptive_scale", [
    (True, "batch_norm", True), (False, "batch_norm", True),
    (True, "layer_norm", True), (True, "batch_norm", False)])
def test_layer_plain_matches_pallas_and_flax(causal, cnn_norm,
                                             adaptive_scale):
    """Ragged lens (one utterance of 0 frames against the Pallas kernel):
    plain twin == Pallas (interpret) == flax layer == the port's eager
    layer, every row, atol 1e-4."""
    B, T = 4, 23
    lens = np.asarray([T, 17, 6, 0], np.int32)
    flax_layer, v = _flax_layer(3 + causal, causal, cnn_norm, adaptive_scale)
    rs = np.random.RandomState(4)
    x = rs.standard_normal((B, T, D)).astype(np.float32)
    pos = rs.standard_normal((1, T, D)).astype(np.float32)
    conv_ln = cnn_norm == "layer_norm"
    packed_j = jsq.pack_sq_layer_params(
        v["params"], v.get("batch_stats"), jnp.float32,
        adaptive_scale=adaptive_scale, conv_ln=conv_ln)
    pos_p = jnp.asarray(pos[0]) @ packed_j.pop("linear_pos")
    want = np.asarray(jsq.fused_squeezeformer_layer(
        jnp.asarray(x), jnp.asarray(lens), pos_p, packed_j, n_head=H,
        ksize=K, causal=causal, conv_ln=conv_ln, interpret=True))
    layer = _load(SqueezeformerEncoderLayer(
        D, H, FF, K, cnn_norm, causal, adaptive_scale),
        {k: {"encoder": {"layer_0": t}} for k, t in v.items()},
        "encoder.encoders.0.")
    with torch.no_grad():
        got = sq.fused_squeezeformer_layer_plain(
            _t(x), torch.from_numpy(lens), layer.self_attn.linear_pos(
                _t(pos[0])), layer.packed_params(), n_head=H, ksize=K,
            causal=causal, conv_ln=conv_ln)
        routed = layer.forward_full_context(_t(x), torch.from_numpy(lens),
                                            _t(pos))
        mask = torch.arange(T)[None, None, :] < torch.from_numpy(lens)[
            :, None, None]
        eager = layer(_t(x), mask, _t(pos), mask)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(routed.numpy(), got.numpy())
    # the flax layer and the eager one over the utterances with frames
    ref, _, _ = flax_layer.apply(v, jnp.asarray(x[:3]),
                                 jnp.asarray(mask[:3].numpy()),
                                 jnp.asarray(pos),
                                 jnp.asarray(mask[:3].numpy()))
    np.testing.assert_allclose(got[:3].numpy(), np.asarray(ref), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(eager[:3].numpy(), np.asarray(ref),
                               atol=1e-4, rtol=0)


# --------------------------------------------------------------------------- #
# bundles and the model at full context
# --------------------------------------------------------------------------- #
def _export(out, streaming, seed):
    """A tiny Squeezeformer bundle that masr_tpu exports, weights from a
    seed, perturbed, the CTC head x8 (frames peak on varied tokens, as a
    trained model's do) → the bundle dir."""
    from masr_tpu.infer.bundle import save_inference_bundle
    from masr_tpu.models.cmvn import GlobalCMVN
    from masr_tpu.models.registry import build_model
    mean, istd = np.full(FEAT, 15.0), np.full(FEAT, 0.33)
    model = build_model("squeezeformer", FEAT, len(VOCAB),
                        streaming=streaming, encoder_conf=ENC,
                        decoder_conf=DEC, model_conf=dict(ctc_weight=0.5),
                        cmvn=GlobalCMVN(mean, istd))
    rng = jax.random.PRNGKey(seed)
    v = jax.jit(model.init, static_argnames=("train",))(
        {"params": rng, "dropout": rng, "chunk": rng},
        jnp.zeros((1, 67, FEAT)), jnp.asarray([67]),
        jnp.zeros((1, 4), jnp.int32), jnp.asarray([4]), train=False)
    v = _perturb(v, seed, 0.1)
    v["params"]["ctc"]["ctc_lo"] = {
        k: t * 8.0 for k, t in v["params"]["ctc"]["ctc_lo"].items()}
    save_inference_bundle(out, "squeezeformer", streaming, FEAT, VOCAB, mean,
                          istd, ENC, DEC, dict(ctc_weight=0.5),
                          {"feature_method": "fbank", "n_mels": FEAT}, v)
    return out


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """{streaming: bundle dir}: streaming (causal, `stream` reduction) and
    offline (non-causal, `conv1d` reduction)."""
    return {s: _export(str(tmp_path_factory.mktemp(f"sq_{s}")), s, 5 + s)
            for s in (True, False)}


# --------------------------------------------------------------------------- #
# weight map
# --------------------------------------------------------------------------- #
def test_weight_map_round_trip_with_batch_stats(bundles):
    """flax → port state_dict → flax, params and batch_stats (the streaming
    bundle's, every variable perturbed), bit for bit; the state fits the
    port's model; every upstream name parses in convert_squeezeformer and
    maps to the same flax array."""
    from flax.traverse_util import flatten_dict
    from masr_tpu.infer.bundle import load_inference_bundle as jax_load
    from masr_tpu.models.convert import convert_squeezeformer
    from masr_tpu_torch.models.registry import build_model
    v = jax_load(bundles[True])[1]
    assert set(v) == {"params", "batch_stats"}
    state = from_flax_variables(v)
    port = build_model("squeezeformer", FEAT, len(VOCAB), streaming=True,
                       encoder_conf=ENC, decoder_conf=DEC)
    want = {k for k in port.state_dict()
            if not k.endswith("num_batches_tracked")}
    assert set(state) == want
    back = to_flax_variables(state)
    assert set(back) == {"params", "batch_stats"}
    for col in ("params", "batch_stats"):
        a, b = flatten_dict(v[col]), flatten_dict(back[col])
        assert set(a) == set(b), col
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), b[k])
    params, stats, misses = convert_squeezeformer(
        {k: t.numpy() for k, t in state.items()}, FEAT, D)
    assert misses == []
    for col, conv in (("params", params), ("batch_stats", stats)):
        a = flatten_dict(v[col])
        assert set(conv) == set(a), col
        for k in a:
            np.testing.assert_array_equal(conv[k], np.asarray(a[k]))


@pytest.mark.parametrize("streaming", [True, False],
                         ids=["stream_reduction", "conv1d_reduction"])
def test_model_probs_match_flax(bundles, streaming):
    """The same bundle at full context: encoder output lengths equal, the
    encoder output within 2e-5 and get_encoder_out's CTC probs within 3e-5
    over the valid frames. The post-norm outputs are LayerNorm rows of
    magnitude up to ~4, where f32 in another sum order leaves ~6e-6 per
    layer even between the port's eager layer and flax's; the bundle's CTC
    head is x8, which multiplies the logits' differences by 8. T' = 32,
    25, 14: 25 is odd, so its reduced length rounds up."""
    from masr_tpu.infer.bundle import load_inference_bundle as jax_load
    from masr_tpu_torch.infer.bundle import load_inference_bundle
    jmodel, jv, _, _ = jax_load(bundles[streaming])
    port, _, _ = load_inference_bundle(bundles[streaming])
    rs = np.random.RandomState(6)
    speech = (15.0 + 3.0 * rs.standard_normal((3, 131, FEAT))).astype(
        np.float32)
    lens = np.asarray([131, 100, 55])
    want_o, _ = jmodel.apply(jv, jnp.asarray(speech), jnp.asarray(lens), -1,
                             -1, method=lambda m, *a: m.encoder(*a))
    want_p, want_l = jmodel.apply(jv, jnp.asarray(speech), jnp.asarray(lens),
                                  method=type(jmodel).get_encoder_out)
    with torch.no_grad():
        got_o, _ = port.encoder(_t(speech), torch.from_numpy(lens))
        got_p, got_l = port.get_encoder_out(_t(speech),
                                            torch.from_numpy(lens))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    assert got_l.tolist() == [32, 25, 14]
    for b, n in enumerate(got_l.tolist()):
        np.testing.assert_allclose(got_o[b, :n].numpy(),
                                   np.asarray(want_o)[b, :n], atol=2e-5,
                                   rtol=0)
        np.testing.assert_allclose(got_p[b, :n].numpy(),
                                   np.asarray(want_p)[b, :n], atol=3e-5,
                                   rtol=0)


def _wave(seed, n_chars):
    """Speech-like audio from the synthetic voice over a noise floor."""
    from masr_tpu_torch.audio.synth_tts import SyntheticTTS
    rs = np.random.RandomState(seed)
    text = "".join(rs.choice(list("上家音月火少风大你下雪蓝右黑真"), n_chars))
    wav = SyntheticTTS(sample_rate=16000).render(text, spk_id=seed % 4)
    return wav + 1e-3 * rs.standard_normal(len(wav)).astype(np.float32)


def _predictors(model_dir, fused=True):
    from masr_tpu.infer.predictor import MASRPredictor as JaxPredictor
    from masr_tpu_torch.infer.predictor import MASRPredictor
    return (MASRPredictor(model_dir=model_dir, device="cpu", warmup=False,
                          fused_frontend=fused),
            JaxPredictor(model_dir=model_dir, warmup=False,
                         fused_frontend=fused))


@pytest.fixture(scope="module")
def stream_predictors(bundles):
    """(port, masr_tpu) predictors on the streaming bundle, per frontend."""
    return {fused: _predictors(bundles[True], fused)
            for fused in (True, False)}


def test_predict_and_predict_batch_match_masr_tpu(stream_predictors):
    """Same texts (and scores within 1e-3), one by one and as a batch."""
    port, ref = stream_predictors[True]
    wavs = [_wave(s, n) for s, n in ((0, 9), (1, 4), (2, 14))]
    got = [port.predict(w) for w in wavs]
    want = [ref.predict(w) for w in wavs]
    assert [g["text"] for g in got] == [w["text"] for w in want]
    for g, w in zip(got, want):
        assert abs(g["score"] - w["score"]) <= 1e-3
    batch = port.predict_batch(wavs)
    assert [g["text"] for g in batch] == [w["text"] for w in
                                          ref.predict_batch(wavs)]
    assert len({g["text"] for g in got}) == 3 and all(g["text"] for g in got)


# --------------------------------------------------------------------------- #
# streaming entry points
# --------------------------------------------------------------------------- #
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
def test_predict_stream_matches_masr_tpu(stream_predictors, fused):
    """Whole and in 0.2 s pieces: the port's text equals masr_tpu's for the
    same feeding."""
    port, ref = stream_predictors[fused]
    assert port.fused_frontend == fused
    texts = []
    for seed, n_chars in ((0, 11), (1, 4)):
        wav = _wave(seed, n_chars)
        for piece in (None, PIECE):
            got, want = _stream(port, wav, piece), _stream(ref, wav, piece)
            assert got == want, (seed, piece)
            texts.append(got)
    assert texts[0] != texts[2] and all(texts)


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


def test_engine_matches_masr_tpu(stream_predictors):
    """Three staggered streams: the port's BatchStreamSession gives
    masr_tpu's engine's texts and its own predict_stream texts, in one
    dispatch per tick (no position tables); a reopened slot gives the same
    text again; tick_chunks=2 (two windows per step, block-causal) gives
    the same texts."""
    from masr_tpu.infer.batch_stream import \
        BatchStreamSession as JaxSession
    from masr_tpu_torch.infer.batch_stream import BatchStreamSession
    port, ref = stream_predictors[False]
    conf = port.predictor.meta["preprocess_conf"]
    waves = [_wave(20 + s, 5 + 4 * s) for s in range(3)]
    sess = BatchStreamSession(port.predictor, port._vocab_list,
                              preprocess_conf=conf, max_streams=4)
    routes = []
    orig = sess._dispatch

    def spy(xs, active, valids, exact):
        routes.append((xs.shape[1], bool(exact)))
        return orig(xs, active, valids, exact)

    sess._dispatch = spy
    got = _interleaved(sess, waves, 4000)
    assert routes and not any(exact for _, exact in routes)
    want = _interleaved(JaxSession(ref.predictor,
                                   ref._text_featurizer.vocab_list,
                                   preprocess_conf=conf, max_streams=4),
                        waves, 4000)
    assert got == want
    assert got == [_stream(port, w) for w in waves]
    assert len(set(got)) == 3
    # slot reuse: the closed slots reopen fresh
    assert _interleaved(sess, waves[::-1], 4000) == got[::-1]
    multi = BatchStreamSession(port.predictor, port._vocab_list,
                               preprocess_conf=conf, max_streams=4,
                               tick_chunks=2)
    assert multi.tick_k == 2
    routes.clear()
    orig = multi._dispatch
    multi._dispatch = spy
    assert _interleaved(multi, waves, 24000) == got
    assert any(k == 2 for k, _ in routes)
