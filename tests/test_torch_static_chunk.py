"""Static-chunk full-context recognition in the port (ConformerEncoder and
SqueezeformerEncoder.forward with static_chunk_size > 0 and no dynamic
chunk) against masr_tpu, on the CPU, at small widths (D=64, 2 heads, conv
kernel 7; the Conformer 2 blocks with FFN 128, the Squeezeformer 3 blocks,
reduce 1 / recover 2, FFN expansion 2), every parameter and BatchNorm
statistic perturbed away from its init, a chunk of 8 frames:

- the Conformer encoder against flax's ConformerEncoder, causal and not,
  B=2 ragged (T' = 130 and 63): once with use_flash_attention=True, so that
  masr_tpu's own `_flash` runs the Pallas kernel in interpret mode, once on
  its XLA path; encoder output atol 2e-5 (f32 over two layers in another
  sum order);
- the Squeezeformer encoder against flax's XLA path with the `stream`
  (causal) and the `conv1d` time reduction, BatchNorm on its perturbed
  running statistics, T' = 32, 25 (odd: its reduced length rounds up), 14:
  atol 2e-5, tests/test_torch_squeezeformer.py's model tolerance (post-norm
  rows of magnitude ~4);
- the whole slice: a tiny static-chunk bundle that masr_tpu exports, per
  family (the Conformer streaming, the Squeezeformer with streaming off,
  the only way masr_tpu builds that family with a static chunk), loads into
  the port's MASRPredictor with no missing or unexpected key; predict and
  predict_batch give masr_tpu's texts, CTC probs within 3e-5 (the bundle's
  CTC head is x8), and every encode calls the flash attention once per
  layer and the full-context layer kernel never.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from masr_tpu_torch.models import attention as attention_module
from masr_tpu_torch.models.weights import from_flax_variables
from test_torch_threads import one_torch_thread  # noqa: F401

D, H, K, FEAT, CHUNK = 64, 2, 7, 80, 8
ENCODER_ATOL, PROBS_ATOL = 2e-5, 3e-5
CONFORMER = dict(output_size=D, attention_heads=H, linear_units=128,
                 num_blocks=2, cnn_module_kernel=K, dropout_rate=0.0,
                 positional_dropout_rate=0.0, attention_dropout_rate=0.0,
                 static_chunk_size=CHUNK, use_dynamic_chunk=False)
SQUEEZEFORMER = dict(encoder_dim=D, output_size=D, attention_heads=H,
                     num_blocks=3, reduce_idx=1, recover_idx=2,
                     feed_forward_expansion_factor=2, cnn_module_kernel=K,
                     static_chunk_size=CHUNK)
DEC = dict(attention_heads=2, linear_units=32, num_blocks=1, r_num_blocks=0)
VOCAB = ["<blank>", "<unk>", "你", "好", "天", "<space>", "<eos>"]


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _perturb(variables, seed, scale=0.05):
    """Every leaf moved off its init: ones (scales, BatchNorm variances) by
    +|N|·scale, the rest by N·scale."""
    rs = np.random.RandomState(seed)
    leaves, treedef = jax.tree.flatten(variables)
    return jax.tree.unflatten(treedef, [
        (np.asarray(l) + (np.abs(rs.standard_normal(l.shape))
                          if l.size and float(np.min(l)) >= 0.9
                          else rs.standard_normal(l.shape)) * scale
         ).astype(np.float32) for l in leaves])


def _cmvn():
    rs = np.random.RandomState(0)
    return (rs.uniform(8, 14, FEAT).astype(np.float32),
            rs.uniform(0.2, 0.5, FEAT).astype(np.float32))


def _speech(lens, seed):
    mean, _ = _cmvn()
    rs = np.random.RandomState(seed)
    return (mean + 3.0 * rs.standard_normal((len(lens), max(lens), FEAT))
            ).astype(np.float32)


def _load_encoder(port, variables):
    """The flax encoder's variables into the port's encoder."""
    state = from_flax_variables({col: {"encoder": t}
                                 for col, t in variables.items()})
    missing, unexpected = port.load_state_dict(
        {k[len("encoder."):]: v for k, v in state.items()}, strict=False)
    assert not unexpected
    assert all(k.endswith("num_batches_tracked") for k in missing), missing
    return port.eval()


class _Spy:
    """Counts the attention module's flash calls and the full-context
    layer kernels' calls (on the CPU their wrappers launch nothing)."""

    def __init__(self, monkeypatch):
        from masr_tpu_torch.models import conformer, squeezeformer
        self.flash = self.layer = 0
        flash = attention_module.rel_pos_flash_attention

        def counted_flash(*a):
            self.flash += 1
            return flash(*a)

        monkeypatch.setattr(attention_module, "rel_pos_flash_attention",
                            counted_flash)
        for mod, name in ((conformer, "fused_conformer_layer"),
                          (squeezeformer, "fused_squeezeformer_layer")):
            monkeypatch.setattr(mod, name, self._count(getattr(mod, name)))

    def _count(self, fn):
        def counted(*a, **kw):
            self.layer += 1
            return fn(*a, **kw)
        return counted


# --------------------------------------------------------------------------- #
# encoders
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("flash", [True, False], ids=["pallas", "xla"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_conformer_encoder_matches_flax(monkeypatch, causal, flash):
    from masr_tpu.models.cmvn import GlobalCMVN as FlaxCMVN
    from masr_tpu.models.conformer import ConformerEncoder as FlaxEncoder
    import masr_tpu.ops.pallas.attention as pa
    from masr_tpu_torch.models.cmvn import GlobalCMVN
    from masr_tpu_torch.models.conformer import ConformerEncoder
    calls = []
    pallas = pa.rel_pos_flash_attention

    def counted(*a, **kw):
        calls.append(kw.get("interpret"))
        return pallas(*a, **kw)

    monkeypatch.setattr(pa, "rel_pos_flash_attention", counted)
    mean, istd = _cmvn()
    lens = [523, 250]
    speech = _speech(lens, 1)
    flax_enc = FlaxEncoder(input_size=FEAT, causal=causal,
                           use_flash_attention=flash,
                           cmvn=FlaxCMVN(mean, istd), **CONFORMER)
    v = flax_enc.init({"params": jax.random.PRNGKey(0)},
                      jnp.asarray(speech), jnp.asarray(lens))
    v = _perturb(jax.device_get(v), 3 + causal)
    calls.clear()
    want, want_mask = flax_enc.apply(v, jnp.asarray(speech),
                                     jnp.asarray(lens), -1, -1)
    assert calls == ([True] * 2 if flash else [])
    port = _load_encoder(ConformerEncoder(
        FEAT, causal=causal, cmvn=GlobalCMVN(mean, istd), **CONFORMER), v)
    spy = _Spy(monkeypatch)
    with torch.no_grad():
        got, mask = port(_t(speech), torch.tensor(lens))
    assert (spy.flash, spy.layer) == (2, 0)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    out_lens = mask[:, 0].sum(1).tolist()
    assert out_lens == [130, 63]
    for b, n in enumerate(out_lens):
        np.testing.assert_allclose(got[b, :n].numpy(), np.asarray(want)[b, :n],
                                   atol=ENCODER_ATOL, rtol=0)


@pytest.mark.parametrize("kind", ["stream", "conv1d"])
def test_squeezeformer_encoder_matches_flax(monkeypatch, kind):
    from masr_tpu.models.cmvn import GlobalCMVN as FlaxCMVN
    from masr_tpu.models.squeezeformer import \
        SqueezeformerEncoder as FlaxEncoder
    from masr_tpu_torch.models.cmvn import GlobalCMVN
    from masr_tpu_torch.models.squeezeformer import SqueezeformerEncoder
    mean, istd = _cmvn()
    lens = [131, 100, 55]
    speech = _speech(lens, 2)
    conf = dict(SQUEEZEFORMER, causal=kind == "stream",
                time_reduction_layer_type=kind, use_dynamic_chunk=False,
                dropout=0.0, input_dropout_rate=0.0,
                attention_dropout_rate=0.0)
    flax_enc = FlaxEncoder(input_size=FEAT, cmvn=FlaxCMVN(mean, istd), **conf)
    v = flax_enc.init({"params": jax.random.PRNGKey(1)},
                      jnp.asarray(speech), jnp.asarray(lens))
    assert set(v) == {"params", "batch_stats"}
    v = _perturb(jax.device_get(v), 5)
    want, want_mask = flax_enc.apply(v, jnp.asarray(speech),
                                     jnp.asarray(lens), -1, -1)
    port = _load_encoder(SqueezeformerEncoder(
        FEAT, cmvn=GlobalCMVN(mean, istd), **conf), v)
    spy = _Spy(monkeypatch)
    with torch.no_grad():
        got, mask = port(_t(speech), torch.tensor(lens))
    assert (spy.flash, spy.layer) == (3, 0)
    out_lens = mask[:, 0].sum(1).tolist()
    assert out_lens == [32, 25, 14]
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    for b, n in enumerate(out_lens):
        np.testing.assert_allclose(got[b, :n].numpy(), np.asarray(want)[b, :n],
                                   atol=ENCODER_ATOL, rtol=0)


# --------------------------------------------------------------------------- #
# the whole slice: bundles through MASRPredictor
# --------------------------------------------------------------------------- #
def _export(out, family, seed):
    """A tiny static-chunk bundle that masr_tpu exports, weights perturbed,
    the CTC head x8 (frames peak on varied tokens, as a trained model's
    do) → (bundle dir, streaming)."""
    from masr_tpu.infer.bundle import save_inference_bundle
    from masr_tpu.models.cmvn import GlobalCMVN
    from masr_tpu.models.registry import build_model
    if family == "conformer":
        enc, streaming = dict(CONFORMER), True
    else:
        enc, streaming = dict(SQUEEZEFORMER), False
    mean, istd = np.full(FEAT, 15.0), np.full(FEAT, 0.33)
    model = build_model(family, FEAT, len(VOCAB), streaming=streaming,
                        encoder_conf=enc, decoder_conf=DEC,
                        model_conf=dict(ctc_weight=0.5),
                        cmvn=GlobalCMVN(mean, istd))
    rng = jax.random.PRNGKey(seed)
    v = jax.jit(model.init, static_argnames=("train",))(
        {"params": rng, "dropout": rng, "chunk": rng},
        jnp.zeros((1, 67, FEAT)), jnp.asarray([67]),
        jnp.zeros((1, 4), jnp.int32), jnp.asarray([4]), train=False)
    v = _perturb(jax.device_get(v), seed, 0.1)
    v["params"]["ctc"]["ctc_lo"] = {
        k: t * 8.0 for k, t in v["params"]["ctc"]["ctc_lo"].items()}
    save_inference_bundle(out, family, streaming, FEAT, VOCAB, mean, istd,
                          enc, DEC, dict(ctc_weight=0.5),
                          {"feature_method": "fbank", "n_mels": FEAT}, v)
    return out


def _wave(seed, n_chars):
    """Speech-like audio from the synthetic voice over a noise floor."""
    from masr_tpu_torch.audio.synth_tts import SyntheticTTS
    rs = np.random.RandomState(seed)
    text = "".join(rs.choice(list("上家音月火少风大你下雪蓝右黑真"), n_chars))
    wav = SyntheticTTS(sample_rate=16000).render(text, spk_id=seed % 4)
    return wav + 1e-3 * rs.standard_normal(len(wav)).astype(np.float32)


@pytest.mark.parametrize("family", ["conformer", "squeezeformer"])
def test_bundle_predict_matches_masr_tpu(tmp_path, monkeypatch, family):
    from masr_tpu.infer.predictor import MASRPredictor as JaxPredictor
    from masr_tpu_torch.infer.bundle import load_inference_bundle
    from masr_tpu_torch.infer.predictor import MASRPredictor
    path = _export(str(tmp_path / family), family, 7)
    model, _, _ = load_inference_bundle(path)       # strict: raises on a miss
    enc = model.encoder
    assert enc.static_chunk_size == CHUNK and not enc.use_dynamic_chunk
    port = MASRPredictor(model_dir=path, device="cpu", warmup=False)
    ref = JaxPredictor(model_dir=path, warmup=False)
    wavs = [_wave(s, n) for s, n in ((0, 9), (1, 4), (2, 14))]
    spy = _Spy(monkeypatch)
    got = [port.predict(w) for w in wavs]
    n_layers = len(enc.encoders)
    assert (spy.flash, spy.layer) == (3 * n_layers, 0)
    want = [ref.predict(w) for w in wavs]
    assert [g["text"] for g in got] == [w["text"] for w in want]
    for g, w in zip(got, want):
        assert abs(g["score"] - w["score"]) <= 1e-3
    assert len({g["text"] for g in got}) == 3 and all(g["text"] for g in got)
    batch = port.predict_batch(wavs)
    assert [g["text"] for g in batch] == [w["text"] for w in
                                          ref.predict_batch(wavs)]
    assert (spy.flash, spy.layer) == (4 * n_layers, 0)
    # the batch's CTC probs over the valid frames
    speech, lens = port.featurize_batch(wavs)
    got_p, got_l = port.predictor.predict(speech, lens)
    want_p, want_l = ref.predictor.predict(speech, lens)
    np.testing.assert_array_equal(got_l, np.asarray(want_l))
    for b, n in enumerate(got_l):
        np.testing.assert_allclose(got_p[b, :n], np.asarray(want_p)[b, :n],
                                   atol=PROBS_ATOL, rtol=0)
