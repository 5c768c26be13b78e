"""bf16 serving of the Squeezeformer, the Efficient-Conformer and
DeepSpeech2 in the port (build_model(dtype=torch.bfloat16),
InferencePredictor(dtype=...), the bf16 modes of rows 6 and 8) against
masr_tpu at dtype=jnp.bfloat16, on the CPU, at small widths (D=64, 2
heads, 3 blocks, conv kernel 7; DeepSpeech2 2 layers of 32 units).

The masr_tpu route each test holds the port against:
- rows 6 and 8: masr_tpu's Pallas kernels at bf16 in interpret mode
  (fused_squeezeformer_layer with both conv norms, fused_chunk_layer_sq at
  full and half rate with an inactive slot) against the plain twins' bf16
  mode;
- the offline encodes: masr_tpu's serving routes at bf16 with its Pallas
  layer kernels in interpret mode (conformer_layer.FORCE_ON_CPU: every
  Squeezeformer layer through fused_squeezeformer_layer, the
  Efficient-Conformer's tail through fused_conformer_layer), DeepSpeech2's
  XLA cells;
- the Squeezeformer's chained stream: masr_tpu's forward_chunk_batched (the
  Pallas chunk kernel per layer, interpret mode), its bf16 caches carried
  into the port halfway by models/weights.py's ring converters; the
  Efficient-Conformer's and DeepSpeech2's streams: masr_tpu's
  forward_chunk / get_encoder_out_chunk (XLA), caches carried as they are;
- the Squeezeformer's static-chunk encode: masr_tpu's bf16 XLA layers, as
  the port runs its eager layers with row 5 there;
- the engines: the port's own bf16 single streams over the same bf16
  predictor.
masr_tpu's routes are compiled with XLA's excess precision off
(`_exact_jit`): with it on (XLA's default) the CPU keeps f32 values
between fused bf16 ops where the code rounds them to bf16 (the
subsampling's product into the pre-LayerNorm, for one), which parts
masr_tpu from its own dtypes by a few roundings.

Tolerances (tests/test_torch_bf16_serving.py's rule): bf16 keeps 8
significant bits, one rounding moves a value by at most 2^-8 of it;
`_bf16_close` allows a max abs error of 8 roundings of the largest value
and a mean abs error of one rounding of the mean magnitude; the f32
probabilities' logs within twice the largest logit error (+1e-5). The one
looser bound, that of a whole model's encode or stream, is explained at
`_MODEL_ROUNDINGS`.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from masr_tpu.models.cmvn import GlobalCMVN as FlaxCMVN
from masr_tpu.models.efficient_conformer import \
    EfficientConformerEncoder as FlaxEffEncoder
from masr_tpu.models.registry import build_model as build_flax_model
from masr_tpu.models.squeezeformer import \
    SqueezeformerEncoder as FlaxSqEncoder
from masr_tpu.models.squeezeformer import \
    SqueezeformerEncoderLayer as FlaxSqLayer
from masr_tpu.ops.pallas import attention as jat
from masr_tpu.ops.pallas import chunk_layer_sq as jck
from masr_tpu.ops.pallas import conformer_layer as jcl
from masr_tpu.ops.pallas import squeezeformer_layer as jsq
from masr_tpu_torch.models.cmvn import GlobalCMVN
from masr_tpu_torch.models.registry import build_model
from masr_tpu_torch.models.squeezeformer import SqueezeformerEncoderLayer
from masr_tpu_torch.models.weights import (from_flax_variables,
                                           right_aligned_from_ring,
                                           ring_from_right_aligned)
from masr_tpu_torch.ops.cuda import chunk_layer_sq as ck
from masr_tpu_torch.ops.cuda import squeezeformer_layer as sq
from test_torch_threads import one_torch_thread  # noqa: F401

BF = torch.bfloat16
D, H, K, FF = 64, 2, 7, 128
d_k = D // H
FEAT = 80
VOCAB = ["<blank>", "<unk>"] + list("上家音月火少风大你下雪蓝右黑真") \
    + ["<space>", "<eos>"]
SQ_ENC = dict(encoder_dim=D, output_size=D, attention_heads=H, num_blocks=3,
              reduce_idx=1, recover_idx=2, feed_forward_expansion_factor=2,
              cnn_module_kernel=K, dropout=0.0, attention_dropout_rate=0.0,
              input_dropout_rate=0.0)
EFF_ENC = dict(output_size=D, attention_heads=H, linear_units=96,
               num_blocks=3, cnn_module_kernel=K,
               cnn_module_norm="layer_norm", dropout_rate=0.0,
               positional_dropout_rate=0.0, attention_dropout_rate=0.0,
               efficient_conf=dict(stride_layer_idx=[1], stride=[2],
                                   group_layer_idx=[0], group_size=3))
DS2_ENC = dict(num_rnn_layers=2, rnn_size=32)
DEC = dict(attention_heads=2, linear_units=32, num_blocks=1, r_num_blocks=0)
ENCS = {"squeezeformer": SQ_ENC, "efficient_conformer": EFF_ENC,
        "deepspeech2": DS2_ENC}
WIN = 67                             # a feature window (16 frames at rate 4)
# A whole encode or stream against masr_tpu (`_MODEL_ROUNDINGS`, in
# roundings as `_bf16_close` counts them): one layer alone keeps the rule
# (the row tests), but f32 sums in another order now and then flip a bf16
# rounding (one subsampling output in a few thousand; an LN statistic one
# f32 ulp off before its row is rounded into a product), and every later
# layer carries the flip on: the attention spreads it over the rows, and
# the post-norm layers (the Squeezeformer) keep no residual stream to
# dilute it. With masr_tpu's own subsampling rows fed in, the static-chunk
# Squeezeformer's encode was masr_tpu's bit for bit. DeepSpeech2 parts
# more steadily: masr_tpu rounds h, c and each gate to bf16 after every op,
# torch's bf16 LSTM / GRU at other points, and the carry passes each
# step's rounding on (see masr_tpu_torch/models/deepspeech2.py). Measured
# on the CPU over seeds 1-8 of `_models` (2 utterances each), per
# utterance: the mean error 0.01-3.54 roundings of the mean magnitude
# (medians 0.01-2.33 by configuration), the max error at most 5.8
# roundings of the largest value. Held to a mean of 4 roundings; the max
# keeps the rule's 8.
_MODEL_ROUNDINGS = (8, 4)


def _f32(a):
    """torch (any dtype) or jax/numpy → numpy f32 (bf16 values exactly)."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _tb(a):
    """jax/numpy → torch bf16 (a bf16 array exactly)."""
    return torch.from_numpy(_f32(a)).to(BF)


def _bf16_close(got, want, n_max=8, n_mean=1):
    """max |got - want| <= n_max roundings (2^-8) of max(1, max |want|);
    mean |got - want| <= n_mean roundings of the mean |want|."""
    got, want = _f32(got), _f32(want)
    err = np.abs(got - want)
    top = max(1.0, float(np.abs(want).max()))
    assert err.max() <= n_max * 2 ** -8 * top, (err.max(), top)
    assert err.mean() <= n_mean * 2 ** -8 * float(np.abs(want).mean()), (
        err.mean(), float(np.abs(want).mean()))


def _probs_close(got, want, logits_got, logits_want, rounds=(8, 1)):
    """bf16 logits _bf16_close, and the f32 probabilities' logs within twice
    the largest logit error (+1e-5)."""
    _bf16_close(logits_got, logits_want, *rounds)
    bound = 2 * np.abs(_f32(logits_got) - _f32(logits_want)).max() + 1e-5
    err = np.abs(np.log(_f32(got)) - np.log(_f32(want)))
    assert err.max() <= bound, (err.max(), bound)


def _perturb(variables, seed, scale=0.05):
    """Every leaf moved off its init: ones (scales, BatchNorm variances)
    by +|N|·scale, the rest by N·scale."""
    rs = np.random.RandomState(seed)
    leaves, treedef = jax.tree.flatten(variables)
    return jax.tree.unflatten(treedef, [
        (np.asarray(l) + (np.abs(rs.standard_normal(l.shape))
                          if l.size and float(np.min(l)) >= 0.9
                          else rs.standard_normal(l.shape)) * scale
         ).astype(np.float32) for l in leaves])


def _exact_jit(fn, *args):
    """fn jitted for args' shapes by XLA with its excess precision off (the
    module docstring) → the compiled callable."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def _bf(rs, shape, scale=1.0):
    return jnp.asarray(rs.standard_normal(shape).astype(np.float32)
                       * scale).astype(jnp.bfloat16)


def _i32(v):
    return torch.tensor(np.asarray(v), dtype=torch.int32)


# --------------------------------------------------------------------------- #
# rows 6 and 8: the twins' bf16 modes against the Pallas kernels at bf16
# --------------------------------------------------------------------------- #
def _sq_layers(seed, causal, cnn_norm):
    """masr_tpu's bf16 pack of a perturbed flax layer and the port's layer
    with the same weights and statistics."""
    layer = FlaxSqLayer(size=D, attention_heads=H, ffn_units=FF,
                        dropout_rate=0.0, attention_dropout_rate=0.0,
                        cnn_module_kernel=K, cnn_norm=cnn_norm, causal=causal)
    x = jnp.zeros((1, 8, D))
    mask = jnp.ones((1, 1, 8), bool)
    v = _perturb(layer.init(jax.random.PRNGKey(seed), x, mask, x, mask),
                 seed)
    port = SqueezeformerEncoderLayer(D, H, FF, K, cnn_norm, causal)
    sd = {k[len("encoder.encoders.0."):]: t for k, t in from_flax_variables(
        {k: {"encoder": {"layer_0": t}} for k, t in v.items()}).items()}
    missing, unexpected = port.load_state_dict(sd, strict=False)
    assert not unexpected and all(
        k.endswith("num_batches_tracked") for k in missing)
    pj = jsq.pack_sq_layer_params(v["params"], v.get("batch_stats"),
                                  jnp.bfloat16,
                                  conv_ln=cnn_norm == "layer_norm")
    pj.pop("linear_pos")
    return pj, port.eval()


@pytest.mark.parametrize("causal,cnn_norm", [(True, "batch_norm"),
                                             (False, "layer_norm")])
def test_row6_bf16_twin_matches_pallas(causal, cnn_norm):
    """fused_squeezeformer_layer's bf16 mode (the twin on CPU tensors, the
    port's bf16 pack: adaptive scales unfolded, products bf16) == masr_tpu's
    fused_squeezeformer_layer at bf16, B=2 ragged (T=40, 27 valid), valid
    rows _bf16_close; the output is bf16."""
    pj, port = _sq_layers(3, causal, cnn_norm)
    rs = np.random.RandomState(0)
    x, posp = _bf(rs, (2, 40, D)), _bf(rs, (40, D), 0.3)
    lens = np.asarray([40, 27], np.int32)
    conv_ln = cnn_norm == "layer_norm"
    want = jsq.fused_squeezeformer_layer(
        x, jnp.asarray(lens), posp, pj, n_head=H, ksize=K, causal=causal,
        conv_ln=conv_ln, interpret=True)
    packed = port.packed_params(BF)
    assert packed["ada"].shape == (4, 2, D) and packed["attw"].dtype == BF
    assert packed["vecb"].dtype == packed["cnw"].dtype == torch.float32
    with torch.no_grad():
        got = sq.fused_squeezeformer_layer(
            _tb(x), torch.from_numpy(lens), _tb(posp), packed, n_head=H,
            ksize=K, causal=causal, conv_ln=conv_ln)
    assert got.dtype == BF
    for b, n in enumerate(lens):
        _bf16_close(got[b, :n], want[b, :n])


@pytest.mark.parametrize("rep", [1, 2], ids=["full_rate", "half_rate"])
def test_row8_bf16_twin_matches_pallas_with_inactive_slot(rep):
    """fused_chunk_layer_sq's bf16 mode == masr_tpu's fused_chunk_layer_sq
    at bf16, four slots on a 64-row full-resolution ring, the layer at
    (16, 64) / rep, cache_len 0, 5, C/2, C, write pointers that wrap, slot
    2 inactive: the active slots' outputs, rings and cnn caches _bf16_close
    (the caches bf16), every half-rate row's two copies bitwise equal, the
    inactive slot's caches bitwise unchanged."""
    B, C_full, c_full = 4, 64, 16
    C, c = C_full // rep, c_full // rep
    rs = np.random.RandomState(10 + rep)
    pj, port = _sq_layers(7, True, "batch_norm")
    x, posp = _bf(rs, (B, c, D), 0.5), _bf(rs, (B, C + c, D), 0.3)
    att, cnn = _bf(rs, (B, H, C, 2 * d_k), 0.5), _bf(rs, (B, K - 1, D), 0.5)
    clens = np.asarray([0, 5, C // 2, C], np.int32)
    y_j, att_j, cnn_j = jck.fused_chunk_layer_sq(
        x, posp, att, cnn, jnp.asarray(clens), pj, n_head=H, ksize=K,
        interpret=True)
    wptr = np.asarray([0, 10, 62, 34], np.int32)
    active = np.asarray([1, 1, 0, 1], bool)
    ring = ring_from_right_aligned(np.repeat(_f32(att), rep, axis=2),
                                   wptr).to(BF)
    cnn_t = _tb(cnn)
    ring0, cnn0 = ring.clone(), cnn_t.clone()
    with torch.no_grad():
        y = ck.fused_chunk_layer_sq(
            _tb(x), _tb(posp).reshape(-1, D), _i32(np.arange(B) * (C + c)),
            ring, cnn_t, _i32(clens), _i32(wptr // rep), _i32(active),
            port.packed_params(BF), n_head=H, ksize=K, conv_ln=False,
            rep=rep)
    assert y.dtype == ring.dtype == cnn_t.dtype == BF
    _bf16_close(y[active], _f32(y_j)[active])
    new = right_aligned_from_ring(ring, (wptr + c_full) % C_full)
    _bf16_close(new[active], np.repeat(_f32(att_j), rep, axis=2)[active])
    _bf16_close(cnn_t[active], _f32(cnn_j)[active])
    assert torch.equal(ring[:, :, 0::2], ring[:, :, 1::2]) or rep == 1
    assert torch.equal(ring[~active], ring0[~active])
    assert torch.equal(cnn_t[~active], cnn0[~active])


def test_sq_wrappers_refuse_mixed_and_other_dtypes():
    """Rows 6 and 8 take f32 or bf16, one of them throughout: a bf16 x with
    the f32 pack, an f32 cache under a bf16 x, or f16 operands raise (no
    silent upcast)."""
    _, port = _sq_layers(1, True, "batch_norm")
    x = torch.randn(2, 8, D, dtype=BF)
    lens = torch.tensor([8, 5], dtype=torch.int32)
    kw = dict(n_head=H, ksize=K, causal=True, conv_ln=False)
    with pytest.raises(ValueError, match="mixed"):
        sq.fused_squeezeformer_layer(x, lens, torch.randn(8, D, dtype=BF),
                                     port.packed_params(), **kw)
    with pytest.raises(ValueError, match="f32 or bf16"):
        sq.fused_squeezeformer_layer(
            x.half(), lens, torch.randn(8, D).half(), port.packed_params(),
            **kw)
    i32 = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="mixed"):
        ck.fused_chunk_layer_sq(
            x, torch.randn(80, D, dtype=BF), i32,
            torch.zeros(2, H, 32, 2 * d_k), torch.zeros(2, K - 1, D,
                                                        dtype=BF),
            i32, i32, i32 + 1, port.packed_params(BF), n_head=H, ksize=K,
            conv_ln=False)


# --------------------------------------------------------------------------- #
# the families' models, offline and streaming
# --------------------------------------------------------------------------- #
def _speech(lens, seed, mean):
    rs = np.random.RandomState(seed)
    return (mean + rs.standard_normal((len(lens), max(lens), FEAT))
            * 3.0).astype(np.float32), np.asarray(lens, np.int32)


def _models(family, streaming, seed, enc=None):
    """(masr_tpu model at bf16, its perturbed f32 variables (the whole
    model's), the port's bf16 model with them, (cmvn mean, istd)); built
    once per arguments (the tests share some)."""
    return _built(family, streaming, seed, tuple(sorted((enc or {}).items())))


@functools.lru_cache(maxsize=None)
def _built(family, streaming, seed, enc):
    rs = np.random.RandomState(seed)
    mean = rs.uniform(8, 14, FEAT).astype(np.float32)
    istd = rs.uniform(0.2, 0.5, FEAT).astype(np.float32)
    conf = dict(ENCS[family], **dict(enc))
    dec = None if family == "deepspeech2" else DEC

    def build(**kw):
        return build_flax_model(family, FEAT, len(VOCAB),
                                streaming=streaming, encoder_conf=conf,
                                decoder_conf=dec, cmvn=FlaxCMVN(mean, istd),
                                **kw)
    f32 = build()
    # the encoder and the CTC head (no decoder: serving reads neither), op
    # by op (quicker than compiling the init)
    v = f32.init({"params": jax.random.PRNGKey(seed)},
                 jnp.zeros((1, WIN, FEAT)), jnp.asarray([WIN]),
                 method=type(f32).get_encoder_out)
    v = _perturb(jax.device_get(v), seed)
    v["params"]["ctc"]["ctc_lo"] = {
        k: t * 8.0 for k, t in v["params"]["ctc"]["ctc_lo"].items()}
    port = build_model(family, FEAT, len(VOCAB), streaming=streaming,
                       encoder_conf=conf, decoder_conf=dec,
                       cmvn=GlobalCMVN(mean, istd), dtype=BF)
    missing, unexpected = port.load_state_dict(from_flax_variables(v),
                                               strict=False)
    assert not unexpected and all(
        k.startswith("decoder.") or k.endswith("num_batches_tracked")
        for k in missing), missing
    return build(dtype=jnp.bfloat16), v, port.eval(), (mean, istd)


def _flax_encode(mdl, speech, lens):
    """masr_tpu's full-context serving encode at its dtype → (encoder rows,
    CTC logits, probs, lengths)."""
    if hasattr(mdl.encoder, "rnns"):
        out, out_lens, _, _ = mdl.encoder(speech, lens)
    else:
        out, mask = mdl.encoder(speech, lens, decoding_chunk_size=-1,
                                num_decoding_left_chunks=-1)
        out_lens = mask[:, 0, :].sum(axis=1).astype(jnp.int32)
    return out, mdl.ctc.ctc_lo(out), mdl.ctc.softmax(out), out_lens


def _check_offline(family, streaming, seed, monkeypatch, enc=None):
    """The port's bf16 full-context encode of two utterances (123 and 90
    frames) against masr_tpu's serving route at bf16 (its Pallas layer
    and flash kernels forced on in interpret mode, as a TPU runs them):
    lengths equal; encoder rows, logits and probs within
    _MODEL_ROUNDINGS over each utterance's valid rows."""
    fm, v, port, cmvn = _models(family, streaming, seed, enc)
    speech, lens = _speech([123, 90], seed, cmvn[0])
    monkeypatch.setattr(jcl, "FORCE_ON_CPU", True)
    monkeypatch.setattr(jat, "FORCE_ON_CPU", True)
    monkeypatch.setattr(jat, "FLASH_CROSSOVER_T", 0)
    args = (jnp.asarray(speech), jnp.asarray(lens))
    h_j, lg_j, p_j, l_j = _exact_jit(lambda s, n: fm.apply(
        v, s, n, method=_flax_encode), *args)(*args)
    with torch.no_grad():
        if family == "deepspeech2":
            enc_t, out_lens, _, _ = port.encoder(torch.from_numpy(speech),
                                                 torch.from_numpy(lens))
            probs = port.ctc.softmax(enc_t)
        else:
            enc_t, probs, out_lens = port.encode_for_rescoring(
                torch.from_numpy(speech), torch.from_numpy(lens))
        logits = port.ctc.logits(enc_t)
    assert enc_t.dtype == logits.dtype == BF and probs.dtype == torch.float32
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(l_j))
    for b, n in enumerate(np.asarray(l_j)):
        _bf16_close(enc_t[b, :n], h_j[b, :n], *_MODEL_ROUNDINGS)
        _probs_close(probs[b, :n], p_j[b, :n], logits[b, :n], lg_j[b, :n],
                     _MODEL_ROUNDINGS)


def test_sq_offline_encode_matches_masr_tpu_bf16(monkeypatch):
    """The bf16 offline Squeezeformer's full-context encode (row 6's bf16
    twin per layer, non-causal, the `conv1d` time reduction and the
    recover in bf16; the causal layers and the `stream` reduction run in
    the chunk stream below)
    against masr_tpu's serving route at bf16, every layer through its
    Pallas kernel in interpret mode: encoder rows and CTC logits bf16 and
    f32 probs within _MODEL_ROUNDINGS (_bf16_close, _probs_close), valid
    rows."""
    _check_offline("squeezeformer", False, 1, monkeypatch)


def test_sq_static_chunk_encode_matches_masr_tpu_bf16(monkeypatch):
    """A static-chunk Squeezeformer (chunk 8, full context otherwise) in
    bf16: the port's eager layers with row 5's bf16 mode (3 launches of
    the flash route per encode, 0 of row 6) against masr_tpu's bf16 XLA
    layers with its Pallas flash attention (its "auto" route with the
    crossover at 0, in interpret mode): encoder rows and probs within
    _MODEL_ROUNDINGS."""
    from masr_tpu_torch.models import attention as attention_module
    from masr_tpu_torch.models import squeezeformer as sq_module
    from masr_tpu_torch.ops.cuda import rel_pos_attention as rpa
    calls = {"flash": 0, "layer": 0}

    def count(name, fn):
        def counted(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return counted
    monkeypatch.setattr(attention_module, "rel_pos_flash_attention",
                        count("flash", rpa.rel_pos_flash_attention))
    monkeypatch.setattr(sq_module, "fused_squeezeformer_layer",
                        count("layer", sq.fused_squeezeformer_layer))
    _check_offline("squeezeformer", False, 4, monkeypatch,
                   dict(static_chunk_size=8))
    assert calls == {"flash": 3, "layer": 0}


def test_eff_offline_encode_matches_masr_tpu_bf16(monkeypatch):
    """The bf16 Efficient-Conformer's full-context encode (grouped and
    stride layers eagerly in bf16, the tail through row 1's bf16 twin,
    masr_tpu's through the Pallas layer kernel in interpret mode; the
    eager BatchNorm1d in bf16 runs in the static-chunk Squeezeformer
    above) against masr_tpu at bf16 (its eager layers' square-mask
    attention through its Pallas flash kernel, as the port's through row
    5): encoder rows and probs within _MODEL_ROUNDINGS."""
    _check_offline("efficient_conformer", False, 5, monkeypatch)


@pytest.mark.parametrize("use_gru", [False, True], ids=["lstm", "gru"])
def test_ds2_offline_encode_matches_masr_tpu_bf16(use_gru, monkeypatch):
    """The bf16 DeepSpeech2 (bidirectional) against masr_tpu's bf16 cells
    over 123 and 90 frames: encoder rows, logits and probs within
    _MODEL_ROUNDINGS."""
    _check_offline("deepspeech2", False, 6 + use_gru, monkeypatch,
                   dict(use_gru=use_gru))


def _flax_encoder(cls, conf, cmvn, v, **kw):
    """masr_tpu's streaming encoder at bf16 (causal, dynamic chunk) and its
    variables out of the model's."""
    enc = cls(input_size=FEAT, causal=True, use_dynamic_chunk=True,
              cmvn=FlaxCMVN(*cmvn), dtype=jnp.bfloat16, **conf, **kw)
    return enc, {k: t["encoder"] for k, t in v.items() if "encoder" in t}


def _windows(cmvn, n, seed):
    mean = cmvn[0]
    rs = np.random.RandomState(seed)
    return (mean + 3.0 * rs.standard_normal((n, 2, WIN, FEAT))).astype(
        np.float32)


def test_sq_chunk_stream_matches_masr_tpu_bf16_with_carried_caches():
    """Four chained chunk steps of the bf16 Squeezeformer (row 8's bf16
    twin per layer, layer 1 at half rate on the ring's rows stored twice)
    against masr_tpu's forward_chunk_batched at bf16 (the Pallas chunk
    kernel per layer, interpret mode), two slots, a 32-row cache that fills
    and wraps: after two steps masr_tpu's bf16 caches are carried into the
    port (ring_from_right_aligned keeps them bf16); every step's output
    and the final caches within _MODEL_ROUNDINGS."""
    fm, v, port, cmvn = _models("squeezeformer", True, 2)
    fenc, enc_v = _flax_encoder(FlaxSqEncoder, SQ_ENC, cmvn, v,
                                time_reduction_layer_type="stream")
    C, CH = 32, 16
    st = fenc.apply(enc_v, method=lambda m: m.init_cache(batch=2,
                                                         cache_size=C))
    att, cnn = st["att_cache"], st["cnn_cache"]
    assert att.dtype == jnp.bfloat16
    offsets = clens = jnp.zeros((2,), jnp.int32)
    windows = _windows(cmvn, 4, 9)
    step = _exact_jit(lambda x, o, a, cn, cl: fenc.apply(
        enc_v, x, o, a, cn, cl, method=type(fenc).forward_chunk_batched),
        jnp.asarray(windows[0]), offsets, att, cnn, clens)
    state = port.encoder.init_cache(batch=2, cache_size=C)
    assert state["att_cache"].dtype == state["cnn_cache"].dtype == BF
    for i, w in enumerate(windows):
        if i == 2:      # carry masr_tpu's caches into the port
            state["att_cache"] = ring_from_right_aligned(
                att, state["wptr"].numpy())
            state["cnn_cache"] = _tb(cnn)
            assert state["att_cache"].dtype == BF
        y_j, att, cnn = step(jnp.asarray(w), offsets, att, cnn, clens)
        offsets, clens = offsets + CH, jnp.minimum(clens + CH, C)
        with torch.no_grad():
            y = port.encoder.forward_chunk(torch.from_numpy(w), state)
        assert y.dtype == BF
        _bf16_close(y, y_j, *_MODEL_ROUNDINGS)
    _bf16_close(right_aligned_from_ring(state["att_cache"], state["wptr"]),
                att, *_MODEL_ROUNDINGS)
    _bf16_close(state["cnn_cache"], cnn, *_MODEL_ROUNDINGS)


def test_eff_chunk_stream_matches_masr_tpu_bf16():
    """Four chained eager chunk steps of the bf16 Efficient-Conformer
    (grouped and stride layers with masr_tpu's right-aligned bf16 caches)
    against masr_tpu's forward_chunk at bf16, two slots, a 32-row cache,
    masr_tpu's caches carried into the port after two steps: outputs and
    final caches within _MODEL_ROUNDINGS."""
    fm, v, port, cmvn = _models("efficient_conformer", True, 10)
    fenc, enc_v = _flax_encoder(FlaxEffEncoder, EFF_ENC, cmvn, v)
    C, CH = 32, 16
    st = fenc.apply(enc_v, method=lambda m: m.init_cache(batch=2,
                                                         cache_size=C))
    att, cnn = st["att_cache"], st["cnn_cache"]
    offset = clen = jnp.int32(0)
    windows = _windows(cmvn, 4, 11)
    step = _exact_jit(lambda x, o, a, cn, cl: fenc.apply(
        enc_v, x, o, a, cn, cl, method=type(fenc).forward_chunk),
        jnp.asarray(windows[0]), offset, att, cnn, clen)
    state = port.encoder.init_cache(batch=2, cache_size=C)
    assert state["att_cache"].dtype == state["cnn_cache"].dtype == BF
    for i, w in enumerate(windows):
        if i == 2:
            state["att_cache"], state["cnn_cache"] = _tb(att), _tb(cnn)
        y_j, att, cnn = step(jnp.asarray(w), offset, att, cnn, clen)
        offset, clen = offset + CH, jnp.minimum(clen + CH, C)
        with torch.no_grad():
            y = port.encoder.forward_chunk(torch.from_numpy(w), state)
        assert y.dtype == BF
        _bf16_close(y, y_j, *_MODEL_ROUNDINGS)
    _bf16_close(state["att_cache"], att, *_MODEL_ROUNDINGS)
    _bf16_close(state["cnn_cache"], cnn, *_MODEL_ROUNDINGS)


@pytest.mark.parametrize("use_gru", [False, True], ids=["lstm", "gru"])
def test_ds2_stream_matches_masr_tpu_bf16(use_gru):
    """Four chained windows of the bf16 DeepSpeech2 (forward): probs and
    the bf16 h and c against masr_tpu's get_encoder_out_chunk at bf16,
    masr_tpu's h and c carried into the port after two windows, within
    _MODEL_ROUNDINGS (probs: their logs within twice the logit error)."""
    fm, v, port, cmvn = _models("deepspeech2", True, 12 + use_gru,
                                dict(use_gru=use_gru))
    jstate = fm.apply(v, method=lambda m: m.init_cache(batch=2))
    windows = _windows(cmvn, 4, 14)
    step = _exact_jit(lambda x, s: fm.apply(
        v, x, s, method=type(fm).get_encoder_out_chunk),
        jnp.asarray(windows[0]), jstate)
    state = port.init_cache(batch=2)
    assert state["h"].dtype == state["c"].dtype == BF
    for i, w in enumerate(windows):
        if i == 2:
            state = {k: _tb(a) for k, a in jstate.items()}
        p_j, jstate = step(jnp.asarray(w), jstate)
        with torch.no_grad():
            before = {k: t.clone() for k, t in state.items()}
            probs = port.get_encoder_out_chunk(torch.from_numpy(w), state)
        assert probs.dtype == torch.float32
        assert not torch.equal(before["h"], state["h"])
        bound = 2 * _MODEL_ROUNDINGS[0] * 2 ** -8 * max(
            1.0, float(np.abs(np.log(_f32(p_j))).max())) + 1e-5
        assert np.abs(np.log(_f32(probs)) - np.log(_f32(p_j))).max() <= bound
    assert jstate["h"].dtype == jnp.bfloat16
    for k in ("h", "c") if not use_gru else ("h",):
        _bf16_close(state[k], jstate[k], *_MODEL_ROUNDINGS)


def test_build_model_bf16_every_family():
    """build_model(dtype=bf16) builds every family: parameters f32, the
    streaming state in bf16; the loss paths of these configurations (the
    BatchNorm Squeezeformer, the Efficient-Conformer, DeepSpeech2) raise on
    bf16 (bf16 training takes the Conformer and the layer_norm
    Squeezeformer, tests/test_torch_bf16_training.py); f16 raises."""
    for family, enc in ENCS.items():
        model = build_model(family, FEAT, 10, encoder_conf=enc,
                            decoder_conf=None if family == "deepspeech2"
                            else DEC, dtype=BF)
        assert all(p.dtype == torch.float32 for p in model.parameters())
        state = model.init_cache(batch=2) if family == "deepspeech2" \
            else model.encoder.init_cache(batch=2, cache_size=16)
        assert {t.dtype for t in state.values() if t.dim() > 1} == {BF}
        with pytest.raises(NotImplementedError, match="enable_amp"):
            model(torch.zeros(1, WIN, FEAT), torch.tensor([WIN]),
                  torch.ones(1, 2, dtype=torch.long), torch.tensor([2]))
        with pytest.raises(ValueError, match="f32 or bf16"):
            build_model(family, FEAT, 10, encoder_conf=enc,
                        dtype=torch.float16)


# --------------------------------------------------------------------------- #
# the bundles: the bf16 predictor and the engine
# --------------------------------------------------------------------------- #
def _wave(seed, n_chars):
    """Speech-like audio from the synthetic voice over a noise floor (the
    engine refuses a window of digital silence)."""
    from masr_tpu_torch.audio.synth_tts import SyntheticTTS
    rs = np.random.RandomState(seed)
    text = "".join(rs.choice(list("上家音月火少风大你下雪蓝右黑真"), n_chars))
    wav = SyntheticTTS(sample_rate=16000).render(text, spk_id=seed % 4)
    return wav + 1e-3 * rs.standard_normal(len(wav)).astype(np.float32)


@pytest.mark.parametrize("family", list(ENCS))
def test_engine_bf16_texts_equal_single_stream(family, tmp_path):
    """A tiny streaming bundle of the family that the port exports (seeded
    weights, the CTC head x8 so that frames peak on varied tokens, dB
    normalization off): its bf16 InferencePredictor keeps bf16 slot
    state, and BatchStreamSession over it gives each of two staggered
    streams the text of the port's predict_stream over the same bf16
    predictor; every text is non-empty, and the closed slots' state is
    zero again."""
    from masr_tpu_torch.infer.batch_stream import BatchStreamSession
    from masr_tpu_torch.infer.bundle import save_inference_bundle
    from masr_tpu_torch.infer.inference_model import InferencePredictor
    from masr_tpu_torch.infer.predictor import MASRPredictor
    from masr_tpu_torch.models.weights import (seeded_state_dict,
                                               to_flax_variables)
    conf, ds2 = ENCS[family], family == "deepspeech2"
    model = build_model(family, FEAT, len(VOCAB), encoder_conf=conf,
                        decoder_conf=None if ds2 else DEC)
    state = seeded_state_dict(model, seed=20)
    state["ctc.ctc_lo.weight"] *= 8.0
    save_inference_bundle(
        str(tmp_path), family, True, FEAT, VOCAB, np.full(FEAT, 15.0),
        np.full(FEAT, 0.33), conf, {} if ds2 else DEC,
        {} if ds2 else dict(ctc_weight=0.5),
        {"feature_method": "fbank", "n_mels": FEAT,
         "use_dB_normalization": False}, to_flax_variables(state))
    ip = InferencePredictor(str(tmp_path), device="cpu", dtype=BF)
    single = MASRPredictor(model_dir=str(tmp_path), device="cpu",
                           warmup=False, fused_frontend=False)
    single.predictor = ip
    waves = [_wave(30 + s, 4 + 3 * s) for s in range(2)]
    want = []
    for w in waves:
        out = single.predict_stream(w, is_end=True, sample_rate=16000)
        single.reset_stream()
        want.append(out["text"])
    sess = BatchStreamSession(ip, ip.vocab_list,
                              preprocess_conf=ip.meta["preprocess_conf"],
                              max_streams=4)
    assert {t.dtype for t in sess.states.values() if t.dim() > 1} == {BF}
    slots = [sess.open() for _ in waves]
    got = {}
    for i in range(0, max(len(w) for w in waves) + 4000, 4000):
        items = [(slot, w[max(i - 4000 * k, 0):i - 4000 * k + 4000],
                  i - 4000 * k + 4000 >= len(w))
                 for k, (slot, w) in enumerate(zip(slots, waves))
                 if 0 <= i - 4000 * k < len(w)]
        for slot, out in sess.feed_many(items).items():
            if out is not None:
                got[slot] = out["text"]
    assert [got[s] for s in slots] == want
    assert all(want)
    for slot in slots:
        sess.close(slot)
    assert all(not t.float().abs().sum() for k, t in sess.states.items()
               if t.dim() > 1)
